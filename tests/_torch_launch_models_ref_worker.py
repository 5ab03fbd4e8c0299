"""The JAX reference's model dry run, for the port's parity tests
(``tests/test_torch_launch_models.py``).

``run(inputs)`` runs this file in a subprocess with 512 forced host
devices and returns:

* ``layouts``: for every configuration (full size, shapes only), FSDP on
  and off, on the (16, 16) and (2, 16, 16) meshes, each parameter leaf's
  ``PartitionSpec`` from ``param_shardings`` by its tree path (``/stack/
  sub0/attn/wq``), with ``state_shardings``' moments and step, and for each
  shape ``batch_shardings``' specs, ``_batch_spec`` and ``cache_shardings``'
  specs by path; specs as tuples, an entry None or a tuple of axis names;
* ``input_specs``: each cell's input shapes and dtypes; ``cells``:
  ``all_cells()``; ``meta``: each cell's record metadata, as ``run_cell``
  computes it;
* ``compiled``: for each case ``(arch, shape, mesh)`` of
  ``inputs["compiled"]``, the reference's ``lower_cell`` and ``analyze`` of
  the reduced configuration at ``inputs["shapes"]``' small shapes on a
  small forced-device mesh ((1, 1), (2, 4) or (2, 2, 2); the module's
  ``get_config``, ``make_production_mesh`` and ``repro.configs.base.
  LM_SHAPES`` are rebound in this process only), with
  ``dot_flops(compiled.as_text())``;
* ``moe``: for each case of ``inputs["moe"]``, the reference's ``moe`` of
  the reduced configuration (capacity factor as given) on the case's
  numpy parameters and input, jitted under a (data, model) mesh.

Usage: python tests/_torch_launch_models_ref_worker.py <inputs.pkl> <out.pkl>
"""
import os
import pickle
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_HERE, "..", "src"))


def run(inputs: dict, timeout: int = 900) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_SRC, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.pkl"), os.path.join(d, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(inputs, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), inp, out],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=os.path.dirname(_HERE))
        assert proc.returncode == 0, f"worker failed:\n{proc.stderr[-3000:]}"
        with open(out, "rb") as f:
            return pickle.load(f)


def _spec(sharding, ndim):
    spec = list(sharding.spec) + [None] * (ndim - len(sharding.spec))
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) or None
                 for e in spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _specs(shardings, structs):
    shapes = dict(_flat(structs))
    return {p: _spec(s, len(shapes[p].shape))
            for p, s in _flat(shardings)}


def _main(inp: dict) -> dict:
    import dataclasses

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import base
    from repro.launch import dryrun as D
    from repro.launch.hlo_analysis import dot_flops
    from repro.launch.mesh import make_production_mesh
    from repro.models import layers, lm
    from repro.core import compat
    from repro.training.train_step import (
        batch_shardings, param_shardings, state_shardings,
    )
    from repro.training.optimizer import init_opt_state

    out = {"layouts": {}, "input_specs": {}, "meta": {}, "compiled": {},
           "moe": {}, "cells": D.all_cells()}
    meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
    for name, cfg in sorted(base.all_configs().items()):
        params = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0),
                                                       cfg))
        n_exp = cfg.moe.n_experts if cfg.moe else None
        for mp, mesh in meshes.items():
            for fsdp in (True, False):
                out["layouts"][(name, fsdp, mp, "params")] = _specs(
                    param_shardings(params, mesh, fsdp=fsdp,
                                    n_experts=n_exp), params)
            state = {"params": params,
                     "opt": jax.eval_shape(init_opt_state, params)}
            st = state_shardings(state, mesh, fsdp=True, n_experts=n_exp)
            out["layouts"][(name, True, mp, "opt")] = {
                "mu": _specs(st["opt"]["mu"], params),
                "nu": _specs(st["opt"]["nu"], params),
                "step": _spec(st["opt"]["step"], 0)}
            for s in cfg.shapes():
                specs = D.input_specs(cfg, s)
                out["layouts"][(name, s.name, mp, "batch")] = _specs(
                    batch_shardings(specs, mesh), specs)
                out["layouts"][(name, s.name, mp, "batch_spec")] = \
                    _spec(jax.sharding.NamedSharding(
                        mesh, D._batch_spec(mesh, s.global_batch)), 1)
                if s.kind == "decode":
                    cache = jax.eval_shape(lambda: lm.init_cache(
                        cfg, s.global_batch, s.seq_len))
                    out["layouts"][(name, s.name, mp, "cache")] = _specs(
                        D.cache_shardings(cache, mesh, s.global_batch),
                        cache)
                    out["layouts"][(name, s.name, mp, "cache_shapes")] = {
                        p: (tuple(x.shape), str(x.dtype))
                        for p, x in _flat(cache)}
        for s in cfg.shapes():
            out["input_specs"][(name, s.name)] = {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in D.input_specs(cfg, s).items()}
            for mp in (False, True):
                out["meta"][(name, s.name, mp)] = {
                    "model_params": cfg.param_count(),
                    "active_params": cfg.active_param_count(),
                    "seq_len": s.seq_len, "global_batch": s.global_batch,
                    "kind": s.kind, "n_chips": 512 if mp else 256}

    # the reduced cells, compiled on small meshes
    devs = np.array(jax.devices())
    small = {"1x1": ((1, 1), ("data", "model")),
             "2x4": ((2, 4), ("data", "model")),
             "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    base.LM_SHAPES = [base.Shape(*s) for s in inp["shapes"]]
    full_get = base.get_config

    def reduced_cfg(arch):
        return base.reduced(full_get(arch))

    D.get_config = reduced_cfg
    for arch, shape, mesh_name in inp["compiled"]:
        dims, axes = small[mesh_name]
        n = int(np.prod(dims))
        D.make_production_mesh = (
            lambda multi_pod=False, dims=dims, axes=axes, n=n:
            Mesh(devs[:n].reshape(dims), axes))
        cfg, s, compiled, _, _ = D.lower_cell(arch, shape, len(dims) == 3)
        rec = D.analyze(compiled, n)
        rec["dot_flops"] = dot_flops(compiled.as_text())
        out["compiled"][(arch, shape, mesh_name)] = rec

    # grouped MoE dispatch under a mesh
    for key, case in inp["moe"].items():
        arch, groups, model_axis, cf = key
        cfg = base.reduced(full_get(arch))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        mesh = Mesh(devs[:groups * model_axis].reshape(groups, model_axis),
                    ("data", "model"))
        compat.set_mesh(mesh)
        got = jax.jit(lambda p, x: layers.moe(p, cfg, x))(
            jax.tree.map(jax.numpy.asarray, case["params"]),
            jax.numpy.asarray(case["x"]))
        out["moe"][key] = np.asarray(got)
    return out


def main():
    inp_path, out_path = sys.argv[1:3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)
    with open(inp_path, "rb") as f:
        inputs = pickle.load(f)
    result = _main(inputs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main()
