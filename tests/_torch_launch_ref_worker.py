"""The JAX reference's SQL dry-run fragments, for the port's parity tests.

``run(inputs)`` runs this file in a subprocess (the test process keeps
JAX's default single device) with 512 forced host devices and returns:

* ``extras``: what ``repro.launch.sql_dryrun``'s ``build_*`` functions return beside the
  function at the reference's own SF100 on ``(256,)`` and ``(2, 256)``
  meshes, built and never lowered;
* ``runs``: for each case ``(shape, multi_pod, label)`` of
  ``inputs["cases"]``, the jitted fragment compiled at ``inputs["sf"]`` on
  the first 8 devices (``(8,)`` or ``(2, 4)``), run on the case's numpy
  inputs (the global, shard-major arrays), with its outputs and
  ``collective_bytes(compiled.as_text())``.  The module's ``SF``, ``ROWS``
  and ``make_sql_mesh`` are set in this process only; no file is edited.

Usage: python tests/_torch_launch_ref_worker.py <inputs.pkl> <out.pkl>
"""
import os
import pickle
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_HERE, "..", "src"))


def run(inputs: dict, timeout: int = 600) -> dict:
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


def _main(inp: dict) -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import repro.relational.table  # noqa: F401 — turns on jax_enable_x64
    from repro.launch import sql_dryrun as sd
    from repro.launch.hlo_analysis import collective_bytes

    def build(shape, multi_pod):
        if shape == "q1":
            return sd.build_q1_fragment(multi_pod)
        return sd.build_q3_fragment(multi_pod, predicate_transfer="pt" in shape,
                                    compress="c" in shape)

    out = {"extras": {}, "runs": {}}
    for shape in ("q1", "q3", "q3pt", "q3c", "q3ptc"):
        for mp in (False, True):
            out["extras"][(shape, mp)] = build(shape, mp)[2]

    sf = inp["sf"]
    sd.SF = sf
    sd.ROWS = {"lineitem": int(6_001_215 * sf), "orders": int(1_500_000 * sf),
               "customer": int(150_000 * sf)}
    devs = np.array(jax.devices()[:8])

    def small_mesh(*, multi_pod=False):
        if multi_pod:
            return Mesh(devs.reshape(2, 4), ("pod", "data"))
        return Mesh(devs, ("data",))

    sd.make_sql_mesh = small_mesh
    for (shape, mp, label), args in inp["cases"].items():
        fn, _, extra = build(shape, mp)
        compiled = fn.lower(*args).compile()
        res = compiled(*args)
        out["runs"][(shape, mp, label)] = {
            "outputs": jax.tree.map(np.asarray, res), "extra": extra,
            "collectives": collective_bytes(compiled.as_text())}
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
