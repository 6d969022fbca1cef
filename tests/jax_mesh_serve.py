"""The JAX engine's ``genserve.generate(mesh=)`` on 4 forced host devices
(a 2x2 ("data", "model") mesh), for ``test_torch_sharded_genserve.py``.

Run as ``python tests/jax_mesh_serve.py IN OUT`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the flag only
takes effect before the first jax import, so the test runs it in an
interpreter of its own.  ``IN`` is a pickle of the job (the smoke arch's
name, its params and the modes, numpy only); ``OUT`` receives each
mode's greedy tokens and mask.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs.archs import SMOKE
from repro.genserve import adapter
from repro.rl.rollout import SamplerConfig


def main(inp: str, out: str) -> None:
    with open(inp, "rb") as f:
        job = pickle.load(f)
    devices = jax.devices()
    assert len(devices) >= 4, devices
    mesh = Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    cfg = SMOKE[job["arch"]]
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    res = {}
    for name, m in job["modes"].items():
        ro, _ = adapter.generate(
            params, cfg, jnp.asarray(m["prompts"]), jax.random.PRNGKey(1),
            SamplerConfig(max_new_tokens=m["N"], greedy=True,
                          eos_token=m.get("eos")),
            fast_path=False, mesh=mesh, **m["kw"])
        res[name] = {k: np.asarray(ro[k]) for k in ("gen_tokens", "mask")}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
