"""Every public name of the reference package has its counterpart in the port.

The reference modules under ``src/repro/`` are read by AST (nothing of
JAX is imported for the walk), which collects, per module:

* each public top-level function and class;
* each public method of a public class;
* each public module-level constant (any public name a top-level
  assignment binds, type aliases included);
* each name a package ``__init__.py`` re-exports with ``from … import``
  from the package itself.

Each name is one case.  It passes when (a) the port's module of the same
path has an attribute of that name after import, (b) it is in
``COUNTERPARTS``, whose target is imported and resolved, or (c) it is in
``BY_DESIGN``, whose replacement file exists and whose name the port's
module really lacks.  ``BY_DESIGN`` holds only ``core/compat.py``'s names,
the Pallas tiling constants and type aliases.

The names that were missing when this test was written have their tests
against the reference at the end of the file (the same inputs through
both packages).
"""
import ast
import importlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

_SHIM = ("src/repro_torch/exchange/service.py",
         "JAX version shim; the port has no JAX, and ShardMesh plays the mesh role")
_ALIAS = "type alias for annotations; the port annotates with torch types"

# reference name -> (file that takes its place, reason)
BY_DESIGN = {
    "core/compat.py:shard_map": _SHIM,
    "core/compat.py:axis_size": _SHIM,
    "core/compat.py:cost_analysis": _SHIM,
    "core/compat.py:get_abstract_mesh": _SHIM,
    "core/compat.py:set_mesh": _SHIM,
    "kernels/decode_attention.py:BLK": (
        "src/repro_torch/csrc/decode_attention.cu", "Pallas KV block size"),
    "kernels/decode_attention.py:NEG_INF": (
        "src/repro_torch/csrc/decode_attention.cu", "Pallas mask fill"),
    "kernels/groupby_agg.py:TILE": (
        "src/repro_torch/csrc/groupby_agg.cu", "Pallas row tile"),
    "kernels/groupby_agg.py:LANE": (
        "src/repro_torch/csrc/groupby_agg.cu", "Pallas lane width"),
    "kernels/hash_probe.py:TILE": (
        "src/repro_torch/csrc/hash_probe.cu", "Pallas row tile"),
    "kernels/join_expand.py:TILE": (
        "src/repro_torch/csrc/join_expand.cu", "Pallas row tile"),
    "kernels/join_expand.py:INT32_SENTINEL": (
        "src/repro_torch/csrc/join_expand.cu", "Pallas padding value"),
    "kernels/topk.py:INT32_SENTINEL": (
        "src/repro_torch/csrc/topk.cu", "Pallas padding value"),
    "kernels/topk.py:F32_INF": (
        "src/repro_torch/csrc/topk.cu", "Pallas padding value"),
    "models/layers.py:Params": ("src/repro_torch/models/layers.py", _ALIAS),
    "relational/table.py:Array": ("src/repro_torch/relational/table.py", _ALIAS),
}

_LM = "repro_torch.models.lm:CausalLM"
_L = "repro_torch.models.layers:"
_FN = "the functional API's params pytree is the module's parameters"

# reference name -> (port target "module:attr[.attr]", reason)
COUNTERPARTS = {
    "kernels/hash_probe.py:MIX32": (
        "repro_torch.kernels.ref:MIX32",
        "the same hash constant, read by the plain twin; hash_probe.cu inlines it"),
    "kernels/ops.py:map_probe_keys_jit": (
        "repro_torch.kernels.ops:map_probe_keys", "jax.jit of it; torch runs it eagerly"),
    "exchange/service.py:compiled_shard_map": (
        "repro_torch.exchange.service:ShardMesh",
        "a sharded program is tensor ops over the mesh's shard axis"),
    "launch/dryrun.py:HBM_PER_CHIP": (
        "repro_torch.launch.dryrun:STATED_CARD_BYTES", "the H100's memory in place of v5e's"),
    "launch/dryrun.py:ARTIFACT_DIR": (
        "repro_torch.launch.dryrun:OUT_DIR", "where the dry run writes its records"),
    "launch/dryrun.py:input_specs": (
        "repro_torch.launch.model_dryrun:input_specs", "the model cells moved to model_dryrun"),
    "launch/dryrun.py:cache_shardings": (
        "repro_torch.launch.model_dryrun:cache_layouts", "shard layouts for NamedShardings"),
    "launch/hlo_analysis.py:collective_bytes": (
        "repro_torch.launch.analysis:CountingMesh.collective_bytes",
        "counted on the mesh's collectives by the same rules, not read from HLO"),
    "launch/hlo_analysis.py:hbm_traffic_estimate": (
        "repro_torch.launch.analysis:OpCounter",
        "bytes accessed counted from the aten ops, not from cost analysis"),
    "launch/hlo_analysis.py:dot_flops": (
        "repro_torch.launch.analysis:matmul_flops", "matmul FLOPs of the aten ops"),
    "launch/hlo_analysis.py:loop_corrected_flops": (
        "repro_torch.launch.analysis:loop_corrected_flops", "over an OpCounter"),
    "training/train_step.py:param_shardings": (
        "repro_torch.launch.sharding:param_layouts", "the GSPMD rules as shard layouts"),
    "training/train_step.py:state_shardings": (
        "repro_torch.launch.sharding:state_layouts", "the GSPMD rules as shard layouts"),
    "training/train_step.py:batch_shardings": (
        "repro_torch.launch.model_dryrun:batch_spec", "batch dims over the data axes"),
    "models/lm.py:init_params": (_LM, "the module's constructor draws the params"),
    "models/lm.py:forward": (_LM + ".forward", _FN),
    "models/lm.py:logits_fn": (_LM + ".logits_fn", _FN),
    "models/lm.py:loss_fn": (_LM + ".loss_fn", _FN),
    "models/lm.py:init_cache": (_LM + ".init_cache", _FN),
    "models/lm.py:decode_step": (_LM + ".decode_step", _FN),
    "models/lm.py:prefill": (_LM + ".prefill", _FN),
    "models/layers.py:init_attention": (_L + "Attention", "the module's constructor"),
    "models/layers.py:attention_train": (_L + "Attention.forward", _FN),
    "models/layers.py:attention_decode": (_L + "Attention.decode", _FN),
    "models/layers.py:init_mla": (_L + "MLA", "the module's constructor"),
    "models/layers.py:mla_train": (_L + "MLA.forward", _FN),
    "models/layers.py:mla_decode": (_L + "MLA.decode", _FN),
    "models/layers.py:init_mlp": (_L + "MLP", "the module's constructor"),
    "models/layers.py:mlp": (_L + "MLP.forward", _FN),
    "models/layers.py:init_moe": (_L + "MoE", "the module's constructor"),
    "models/layers.py:moe": (_L + "MoE.forward", _FN),
    "models/layers.py:init_mamba": (_L + "Mamba", "the module's constructor"),
    "models/layers.py:mamba_train": (_L + "Mamba.forward", _FN),
    "models/layers.py:mamba_decode": (_L + "Mamba.decode", _FN),
}

TILING = {"TILE", "LANE", "BLK", "MIX32", "NEG_INF", "F32_INF", "INT32_SENTINEL"}
ALIASES = {"Array", "Params"}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _module_names(path: Path):
    """(name, kind) of every public name ``path`` defines or re-exports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, "function"))
        elif isinstance(node, ast.ClassDef):
            out.append((node.name, "class"))
            if _public(node.name):
                out += [(f"{node.name}.{m.name}", "method") for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and _public(m.name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out += [(t.id, "constant") for t in targets if isinstance(t, ast.Name)]
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level > 0 or (node.module or "").split(".")[0] == "repro")):
            out += [(a.asname or a.name, "re-export") for a in node.names
                    if a.name != "*"]
    seen, names = set(), []
    for name, kind in out:
        if _public(name.split(".")[0]) and name not in seen:
            seen.add(name)
            names.append((name, kind))
    return names


def _port_module(rel: Path) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("repro_torch",) + parts)


def _collect():
    cases = {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF)
        for name, kind in _module_names(path):
            cases[f"{rel.as_posix()}:{name}"] = (_port_module(rel), name, kind)
    return cases


CASES = _collect()


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _has(module: str, name: str) -> bool:
    try:
        _resolve(importlib.import_module(module), name)
    except (ImportError, AttributeError):
        return False
    return True


@pytest.mark.parametrize("key", sorted(CASES))
def test_public_name_has_its_counterpart(key):
    module, name, kind = CASES[key]
    if key in COUNTERPARTS:
        target, reason = COUNTERPARTS[key]
        mod, attr = target.split(":")
        assert reason and _has(mod, attr), f"{key} -> {target} does not resolve"
        return
    if key in BY_DESIGN:
        path, reason = BY_DESIGN[key]
        assert reason and (ROOT / path).is_file(), (key, path)
        assert not _has(module, name), f"{key} is in the port: drop it from BY_DESIGN"
        return
    assert _has(module, name), f"{kind} {key} has no counterpart in {module}"


def test_the_walk_sees_the_whole_reference():
    modules = {k.split(":")[0] for k in CASES}
    assert len(modules) >= 60, len(modules)
    assert len(CASES) > 700, len(CASES)
    for key in ("relational/table.py:Table.to_pylist", "core/plan.py:ReadRel",
                "relational/__init__.py:like_to_regex",
                "substrait/registry.py:HOST_RELS", "models/layers.py:Params"):
        assert key in CASES, key


def test_tables_name_only_walked_names():
    for key in list(COUNTERPARTS) + list(BY_DESIGN):
        assert key in CASES, f"{key} is not a public name of the reference"
    assert not set(COUNTERPARTS) & set(BY_DESIGN)


def test_by_design_holds_only_compat_tiling_constants_and_aliases():
    for key in BY_DESIGN:
        path, name = key.split(":")
        assert (path == "core/compat.py"
                or (re.fullmatch(r"kernels/\w+\.py", path) and name in TILING)
                or name in ALIASES), key


def test_counterpart_modules_exist_for_every_ported_module():
    """Every reference module has a port module of the same path, except
    the two whose names all live elsewhere (the tables above)."""
    missing = sorted({m for m, _, _ in CASES.values()
                      if importlib.util.find_spec(m) is None})
    assert missing == ["repro_torch.core.compat",
                       "repro_torch.launch.hlo_analysis"], missing


# ---------------------------------------------------------------------------
# the names that were missing, against the reference on the same inputs
# ---------------------------------------------------------------------------

from repro.core import instrument as ref_instrument  # noqa: E402
from repro.relational import expressions as ref_expressions  # noqa: E402
from repro.relational import like_to_regex as ref_like_to_regex  # noqa: E402
from repro.relational.table import Column as RefColumn  # noqa: E402
from repro.relational.table import Table as RefTable  # noqa: E402
from repro.substrait import registry as ref_registry  # noqa: E402
from repro_torch.core import instrument  # noqa: E402
from repro_torch.relational import expressions, like_to_regex  # noqa: E402
from repro_torch.relational.table import Column, Table  # noqa: E402
from repro_torch.substrait import registry  # noqa: E402

DATES = ["1970-01-01", "1992-02-29", "1998-12-01", "1969-12-31", "2038-01-19"]


def _host_table():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(-5, 5, 6).astype(np.int64),
            "v": rng.normal(size=6),
            "s": np.array(["b", "a", "c", "a", "bb", "b"]),
            "d": np.array(DATES + ["1995-06-17"], dtype="datetime64[D]")}


def test_column_from_dates_equals_the_reference():
    got, want = Column.from_dates(DATES), RefColumn.from_dates(DATES)
    assert got.kind == want.kind
    assert got.data.dtype == torch.int32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data.device.type == "cpu"


def test_column_decode_equals_the_reference():
    host = _host_table()
    for name, arr in host.items():
        got, want = Column.from_numpy(arr).decode(), RefColumn.from_numpy(arr).decode()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mapping", [{}, {"v": "value"}, {"k": "s", "s": "k"},
                                     {"absent": "x", "d": "day"}])
def test_table_rename_equals_the_reference(mapping):
    host = _host_table()
    got = Table.from_pydict(host).rename(mapping)
    want = RefTable.from_pydict(host).rename(mapping)
    assert got.column_names == want.column_names
    for n in want.column_names:
        np.testing.assert_array_equal(got[n].to_host(), want[n].to_host())


@pytest.mark.parametrize("names", [[], ["v"], ["k", "d", "absent"], ["k", "v", "s", "d"]])
def test_table_drop_equals_the_reference(names):
    host = _host_table()
    got = Table.from_pydict(host).drop(names)
    want = RefTable.from_pydict(host).drop(names)
    assert got.column_names == want.column_names


def test_table_to_pylist_equals_the_reference():
    host = _host_table()
    got = Table.from_pydict(host).to_pylist()
    want = RefTable.from_pydict(host).to_pylist()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for n in w:
            assert type(g[n]) is type(w[n]), (n, type(g[n]), type(w[n]))
            assert g[n] == w[n], n


def test_transfer_counter_reset_equals_the_reference():
    got, want = instrument.TransferCounter(), ref_instrument.TransferCounter()
    for c in (got, want):
        for flag in (True, False, True):
            c.record(flag)
        assert (c.total, c.in_pipeline) == (3, 2)
        c.reset()
        assert (c.total, c.in_pipeline) == (0, 0)
        c.record(True)
    assert (got.total, got.in_pipeline) == (want.total, want.in_pipeline)


@pytest.mark.parametrize("name", sorted(ref_registry.FUNCTIONS))
def test_function_uri_equals_the_reference(name):
    assert registry.function_uri(name) == ref_registry.function_uri(name)


def test_function_uri_covers_the_same_functions():
    assert registry.FUNCTIONS == ref_registry.FUNCTIONS
    with pytest.raises(KeyError):
        registry.function_uri("no_such_function")


def test_host_rels_equal_the_reference():
    assert registry.HOST_RELS == ref_registry.HOST_RELS
    assert registry.HOST_RELS == registry.DEVICE_RELS | {"SetRel", "WindowRel"}


@pytest.mark.parametrize("pattern", ["%", "a%", "%b_", "100\\%", "x_y%z", "a.b*c",
                                     "%special%requests%", "[a]%"])
def test_like_to_regex_reexports_equal_the_reference(pattern):
    want = ref_like_to_regex(pattern)
    for fn in (like_to_regex, expressions.like_to_regex):
        got = fn(pattern)
        assert (got.pattern, got.flags) == (want.pattern, want.flags)
    assert ref_expressions.like_to_regex(pattern).pattern == want.pattern
