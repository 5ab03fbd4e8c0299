"""The JAX reference on 8 forced host devices, for the port's parity tests.

``run(mode, inputs)`` runs this file in a subprocess (the test process keeps
JAX's default single device) and returns what it computed:

* ``exchange``: the collectives of ``repro.exchange.service`` and
  ``repro.exchange.bloom`` under ``shard_map`` on an 8-shard ``('data',)``
  mesh (a ``(2, 4)`` ``('pod', 'data')`` mesh for ``shuffle_hierarchical``)
  over the sharded inputs the test made, each output in its global
  (shard-major) layout;
* ``distributed``: ``repro.core.distributed.DistributedEngine`` at
  ``inputs["n"]`` shards over TPC-H at ``inputs["sf"]``: each query's
  result, ``exchange_summary()`` (without the wall times) and fragment
  names, with speculative backups off.

Usage: python tests/_torch_dist_ref_worker.py <mode> <inputs.pkl> <out.pkl>
"""
import os
import pickle
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_HERE, "..", "src"))


def run(mode: str, inputs: dict, timeout: int = 600) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.pkl"), os.path.join(d, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(inputs, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), mode, inp, out],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=os.path.dirname(_HERE))
        assert proc.returncode == 0, f"worker failed:\n{proc.stderr[-3000:]}"
        with open(out, "rb") as f:
            return pickle.load(f)


def _exchange(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    import repro.relational.table  # noqa: F401 — turns on jax_enable_x64
    from repro.core import compat
    from repro.exchange import bloom, service
    from repro.exchange.service import Frame

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    cols = {k: jnp.asarray(v) for k, v in inp["cols"].items()}
    valid = jnp.asarray(inp["valid"])

    def smap(fn, n_in, mesh=mesh, spec=P("data")):
        return jax.jit(compat.shard_map(fn, mesh, in_specs=(spec,) * n_in,
                                        out_specs=spec))

    def host(tree):
        return jax.tree.map(np.asarray, tree)

    out = {}
    for out_cap in inp["out_caps"]:
        def by_dest(c, v, dest, out_cap=out_cap):
            fr, ov = service.shuffle_by_dest(Frame(c, v), dest, "data", out_cap)
            return fr.columns, fr.valid, jnp.broadcast_to(ov, (1,))

        def by_key(c, v, key, out_cap=out_cap):
            fr, ov = service.shuffle(Frame(c, v), key, "data", out_cap)
            return fr.columns, fr.valid, jnp.broadcast_to(ov, (1,))

        out[("shuffle_by_dest", out_cap)] = host(smap(by_dest, 3)(
            cols, valid, jnp.asarray(inp["dest"])))
        out[("shuffle", out_cap)] = host(smap(by_key, 3)(
            cols, valid, jnp.asarray(inp["keys"])))

    def bcast(c, v):
        fr = service.broadcast(Frame(c, v), "data")
        return fr.columns, fr.valid

    def merge(c, v):
        fr = service.merge(Frame(c, v), "data")
        return fr.columns, fr.valid

    out["broadcast"] = host(smap(bcast, 2)(cols, valid))
    out["merge"] = host(smap(merge, 2)(cols, valid))
    for g in inp["group_sizes"]:
        def mcast(c, v, g=g):
            fr = service.multicast(Frame(c, v), "data", g)
            return fr.columns, fr.valid
        out[("multicast", g)] = host(smap(mcast, 2)(cols, valid))

    def psum(x):
        return service.all_reduce_sum(x, "data")
    out["all_reduce_sum"] = host(smap(psum, 1)(jnp.asarray(inp["counts"])))

    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("pod", "data"))
    for caps in inp["hier_caps"]:
        def hier(c, v, caps=caps):
            fr, ov = service.shuffle_hierarchical(
                Frame(c, v), "k", "pod", "data", *caps)
            return fr.columns, fr.valid, jnp.broadcast_to(ov, (1,))
        out[("shuffle_hierarchical", caps)] = host(
            smap(hier, 2, mesh=mesh2, spec=P(("pod", "data")))(cols, valid))

    m_bits, k = inp["bloom_m_bits"], inp["bloom_k"]

    def bloom_shards(keys, v):
        bits = bloom.bloom_build(keys, v, m_bits, k)
        return bits, bloom.bloom_or_across(bits, ("data",))
    local, combined = smap(bloom_shards, 2)(cols["k"], valid)
    out["bloom_local"] = np.asarray(local)
    out["bloom_combined"] = np.asarray(combined)
    probe = jnp.asarray(inp["bloom_probe"])
    out["bloom_contains"] = np.asarray(bloom.bloom_maybe_contains(
        jnp.asarray(np.asarray(combined)[:m_bits]), probe, k))
    return out


def _distributed(inp: dict) -> dict:
    from repro.core.distributed import DistributedEngine
    from repro.data.tpch import generate

    eng = DistributedEngine(generate(inp["sf"]), n_shards=inp["n"])
    # no speculative backups: a losing replica would still be running JAX
    # work on its daemon thread when the process exits (and aborts)
    eng.speculative.min_budget_s = 1e9
    out = {}
    for qid in inp["qids"]:
        rows = eng.run_query(qid)
        summary = [{k: v for k, v in s.items() if k != "wall_s"}
                   for s in eng.exchange_summary()]
        out[qid] = {"rows": rows, "exchanges": summary,
                    "names": eng.program_names(qid)}
    return out


def main():
    mode, inp_path, out_path = sys.argv[1:4]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)
    with open(inp_path, "rb") as f:
        inputs = pickle.load(f)
    result = {"exchange": _exchange, "distributed": _distributed}[mode](inputs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main()
