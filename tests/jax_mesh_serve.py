"""The JAX package on 4 forced host devices (a 2x2 ("data", "model")
mesh): the engine's ``genserve.generate(mesh=)``, for
``test_torch_sharded_genserve.py`` and ``test_torch_moe_mesh.py``, and
``hlo_analysis`` of the jitted smoke steps sharded as the reference's
dry-run shards them, for ``test_torch_moe_mesh.py`` and
``test_torch_dryrun_memory.py``.

Run as ``python tests/jax_mesh_serve.py IN OUT`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the flag only
takes effect before the first jax import, so the test runs it in an
interpreter of its own.  ``IN`` is a pickle of the job, numpy only:

* serving (no ``kind``): the smoke arch's name, optionally ``overrides``
  of its config's fields, its params and the modes; ``OUT`` receives
  each mode's greedy tokens and mask; or ``runs``, name -> such a job
  (with its ``mesh_shape``, 2x2 by default), and ``OUT`` receives name
  -> its modes' results;
* ``kind`` "counts": ``configs`` (name -> (arch, overrides)), ``phases``,
  ``batch`` and ``seq``; ``OUT`` receives, per (name, phase), the
  per-device FLOPs and XLA's memory sizes of the step.

The mesh is built from the devices directly: ``jax.make_mesh`` gives
explicit axes under newer JAX, which the reference's sharding
constraints refuse.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs.archs import SMOKE
from repro.genserve import adapter
from repro.rl.rollout import SamplerConfig


def _mesh(shape=(2, 2)):
    devices = jax.devices()
    assert len(devices) >= 4, devices
    return Mesh(np.array(devices[:4]).reshape(shape), ("data", "model"))


def _cfg(arch, overrides=None):
    return dataclasses.replace(SMOKE[arch], **(overrides or {}))


def serve(job, mesh):
    cfg = _cfg(job["arch"], job.get("overrides"))
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    res = {}
    for name, m in job["modes"].items():
        ro, _ = adapter.generate(
            params, cfg, jnp.asarray(m["prompts"]), jax.random.PRNGKey(1),
            SamplerConfig(max_new_tokens=m["N"], greedy=True,
                          eos_token=m.get("eos")),
            fast_path=False, mesh=mesh, **m["kw"])
        res[name] = {k: np.asarray(ro[k]) for k in ("gen_tokens", "mask")}
    return res


def count(cfg, phase: str, batch: int, seq: int, mesh):
    """The reference dry-run's lowering (``repro.launch.dryrun``) of one
    smoke step on ``mesh``: per-device FLOPs (``hlo_analysis``) and
    ``memory_analysis``'s sizes."""
    from repro.configs.shapes import InputShape, input_specs
    from repro.launch import hlo_analysis, steps
    from repro.models import transformer as T
    from repro.optim import adam
    from repro.parallel.sharding import use_hints
    shape = InputShape("smoke", seq, batch, phase)
    params = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    p_sh = steps.param_shardings(mesh, params)
    batch_shape = input_specs(cfg, shape)
    b_sh = steps.batch_shardings(mesh, batch_shape, shape)
    if phase == "train":
        oc = adam.AdamConfig()
        opt = jax.eval_shape(lambda: adam.init_adam_state(params, oc))
        o_sh = steps.opt_shardings(mesh, params)
        step = steps.make_train_step(cfg, oc)
        in_sh, out_sh = (p_sh, o_sh, b_sh), (p_sh, o_sh, None)
        args = (params, opt, batch_shape)
    elif phase == "prefill":
        step = steps.make_prefill_step(cfg, max_cache_len=seq)
        in_sh, out_sh, args = (p_sh, b_sh), None, (params, batch_shape)
    else:
        step = steps.make_serve_step(cfg)
        in_sh, out_sh = (p_sh, b_sh), (None, b_sh["cache"])
        args = (params, batch_shape)
    with mesh, use_hints(steps.activation_rules(mesh, shape)):
        compiled = jax.jit(step, in_shardings=in_sh,
                           out_shardings=out_sh).lower(*args).compile()
    mem = compiled.memory_analysis()
    out = {"flops_per_device":
           float(hlo_analysis.analyze(compiled.as_text()).flops)}
    for attr in ("temp_size_in_bytes", "argument_size_in_bytes",
                 "output_size_in_bytes"):
        out[attr] = int(getattr(mem, attr))
    return out


def counts(job, mesh):
    return {(name, phase): count(_cfg(arch, ov), phase, job["batch"],
                                 job["seq"], mesh)
            for name, (arch, ov) in job["configs"].items()
            for phase in job["phases"]}


def main(inp: str, out: str) -> None:
    with open(inp, "rb") as f:
        job = pickle.load(f)
    mesh = _mesh()
    if job.get("kind") == "counts":
        res = counts(job, mesh)
    elif "runs" in job:
        res = {name: serve(run, _mesh(run.get("mesh_shape", (2, 2))))
               for name, run in job["runs"].items()}
    else:
        res = serve(job, mesh)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
