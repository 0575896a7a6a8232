"""The port's GPipe (repro_torch/train/pipeline_parallel.py ``gpipe_apply``)
against the reference's (repro/train/pipeline_parallel.py) and the
sequential stack.

The reference test's stack (tests/test_distributed.py:25-49): L 8 layers of
``tanh(x @ w + b)``, D 16, x (8, 4, D), 4 microbatches, from numpy seed 0
(tests/torch_mesh_ranks.py ``pipeline_inputs``).  Four gloo ranks
(tests/torch_ranks.py, fresh interpreters without JAX) each hold 2 layers
and differentiate ``sum(y ** 2)``; one JAX interpreter with 4 forced host
devices runs the reference's ``gpipe_apply`` on a ``jax.sharding.Mesh``
with Auto axes (``jax.make_mesh`` gives Explicit axes in jax 0.9, under
which the reference's own test fails), jitted.  Every rank's output equals
the reference's and the sequential stack's, and its layers' gradients (and
x's) equal the rows of the reference's gradients and the sequential ones,
at ``rtol`` = ``atol`` = 1e-5 in f32 (the reference's pipeline against its
own sequential stack: 1.9e-6 at a largest gradient of 18.9).
"""
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks_lib
import torch_ranks
from torch_parity import torch_one_thread  # noqa: F401

P = 4
LIMIT_S = 120
TOL = dict(rtol=1e-5, atol=1e-5)

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.train.pipeline_parallel import gpipe_apply
d = np.load(sys.argv[1])
layers = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
x = jnp.asarray(d["x"])
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pipe",))
def block(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])
run = lambda ls, x: gpipe_apply(mesh, "pipe", ls, block, x, int(d["m"]))
y = jax.jit(run)(layers, x)
g, gx = jax.jit(jax.grad(lambda ls, x: jnp.sum(run(ls, x) ** 2),
                         argnums=(0, 1)))(layers, x)
np.savez(sys.argv[2], y=np.asarray(y), gw=np.asarray(g["w"]),
         gb=np.asarray(g["b"]), gx=np.asarray(gx))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    layers, x = ranks_lib.pipeline_inputs()
    np.savez(out / "in.npz", x=x, m=ranks_lib.PIPE_M, **layers)
    procs = torch_ranks.start_ranks(ranks_lib.__file__, ["pipeline"], P, out)
    procs.append(torch_ranks.start_jax(
        _REFERENCE, [out / "in.npz", out / "ref.npz"], P, out))
    torch_ranks.wait_all(procs, out, LIMIT_S)
    return torch_ranks.load_ranks(out, P), dict(np.load(out / "ref.npz"))


def _sequential():
    """The stack run layer by layer in one process: output, gradients."""
    layers, x = ranks_lib.pipeline_inputs()
    ls = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in layers.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt
    for i in range(ranks_lib.PIPE_L):
        h = ranks_lib.pipe_block({k: v[i] for k, v in ls.items()}, h)
    torch.sum(h ** 2).backward()
    return dict(y=h.detach().numpy(), gx=xt.grad.numpy(),
                gw=ls["w"].grad.numpy(), gb=ls["b"].grad.numpy())


@pytest.mark.parametrize("against", ["reference", "sequential"])
def test_pipeline_matches(runs, against):
    ranks, ref = runs
    want = ref if against == "reference" else _sequential()
    n = ranks_lib.PIPE_L // P
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["y"], want["y"], **TOL)
        np.testing.assert_allclose(got["gx"], want["gx"], **TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(got["grads"][k],
                                       want["g" + k][r * n:(r + 1) * n],
                                       **TOL)

