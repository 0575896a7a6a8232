"""The port's compressed gradient mean (repro_torch/train/compression.py)
on four gloo ranks against the reference's (repro/train/compression.py).

A module fixture runs tests/torch_mesh_ranks.py's ``compression`` scenario
on 4 ranks (tests/torch_ranks.py: fresh interpreters with no JAX, one
thread each, killed after 120 s; this process never joins a group).  The
reference's collectives run here under ``jax.vmap`` with named axes in
place of a mesh (``pmax``/``psum`` bind to a vmapped axis name as to a
mesh axis).  Held:

  * replicated gradients come back within 0.02 of themselves relative to
    their largest magnitude (the reference's
    ``test_compressed_gradient_allreduce``, tests/test_distributed.py:52);
  * rounded to nearest, the port's int32 sums and scale equal the
    reference's (``int8_scale`` of the absmax over all ranks, each rank's
    ``round_int8(g / scale)`` summed in int32), and ``quantized_psum``'s
    mean the reference's ``quantized_psum(g, axes, None)``, bit for bit,
    over one axis and over two, in f32 and bf16;
  * stochastic rounding cannot give ``jax.random``'s bits: every element
    within one int8 step (``scale``) of the exact mean, the same bits on
    every rank, another seed other bits, and unbiased over 300 seeds (the
    mean error within 6 standard errors per element and 4 over all, as
    tests/test_torch_quantize.py holds the rounding core);
  * a list of gradients gives the dict's bits; a mesh with no data axis
    passes the gradients through;
  * what a rank sends per leaf: one f32 ``pmax`` (4 B) and the int32 sum,
    4 B an element, as many bytes as an f32 mean's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks_lib
import torch_ranks
from torch_parity import torch_one_thread  # noqa: F401

from repro.core import quantize as jquantize
from repro.train import compression as jcompression

P = ranks_lib.WORLD
LIMIT_S = 120


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression")
    procs = torch_ranks.start_ranks(ranks_lib.__file__, ["compression"], P,
                                    out)
    torch_ranks.wait_all(procs, out, LIMIT_S)
    return torch_ranks.load_ranks(out, P)


def _same_bits(values: list) -> None:
    for other in values[1:]:
        assert torch.equal(values[0], other)


def _stacked(name: str) -> jnp.ndarray:
    x = ranks_lib.compression_inputs()["per_rank"][name]
    return jnp.asarray(x, jnp.bfloat16 if name == "c" else jnp.float32)


def _scale(name: str) -> np.ndarray:
    x = _stacked(name).astype(jnp.float32)
    return np.asarray(jquantize.int8_scale(jnp.max(jnp.abs(x))))


def test_replicated_gradients_come_back(ranks):
    rep = ranks_lib.compression_inputs()["replicated"]
    for r in ranks:
        for k, ref in rep.items():
            got = r["replicated"][k].numpy()
            err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
            assert err < 0.02, (k, err)
    for k in rep:
        _same_bits([r["replicated"][k] for r in ranks])


@pytest.mark.parametrize("name", ["a", "b", "c", "z"])
def test_int32_sums_and_scale_match_the_reference(ranks, name):
    stacked = _stacked(name).astype(jnp.float32)
    scale = jquantize.int8_scale(jnp.max(jnp.abs(stacked)))
    want = sum(np.asarray(jquantize.round_int8(stacked[i] / scale)
                          .astype(jnp.int32)) for i in range(P))
    for r in ranks:
        summed, got_scale = r["int8_sum"][name]
        assert summed.dtype == torch.int32
        np.testing.assert_array_equal(summed.numpy(), want)
        np.testing.assert_array_equal(got_scale.numpy(), np.asarray(scale))


@pytest.mark.parametrize("name", ["a", "b", "c", "z"])
def test_nearest_mean_matches_the_reference_bit_for_bit(ranks, name):
    f = lambda axes: lambda g: jcompression.quantized_psum(g, axes, None)
    x = _stacked(name)
    one = jax.vmap(f(("data",)), axis_name="data")(x)
    two = jax.vmap(jax.vmap(f(("pod", "data")), axis_name="data"),
                   axis_name="pod")(x.reshape((2, 2) + x.shape[1:]))
    for i, r in enumerate(ranks):
        for key, want in (("nearest", one[i]),
                          ("two_axes_nearest", two[i // 2, i % 2])):
            got = r[key][name]
            assert got.dtype == (torch.bfloat16 if name == "c"
                                 else torch.float32)
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("key", ["stochastic", "two_axes"])
@pytest.mark.parametrize("name", ["a", "b", "c", "z"])
def test_stochastic_mean_within_one_step_on_every_rank(ranks, key, name):
    _same_bits([r[key][name] for r in ranks])
    exact = np.asarray(_stacked(name).astype(jnp.float32)).mean(0)
    got = ranks[0][key][name].float().numpy()
    # bf16's own rounding of the result adds up to half its ulp
    slack = np.abs(exact) * 2 ** -8 if name == "c" else 0.0
    assert (np.abs(got - exact) <= _scale(name) * (1 + 1e-6) + slack).all()
    if name in ("a", "b"):
        assert not torch.equal(ranks[0]["stochastic_seed1"][name],
                               ranks[0]["stochastic"][name])
    if name == "z":
        assert not got.any()


def test_stochastic_mean_is_unbiased(ranks):
    draw = ranks_lib.compression_inputs()["draw"]
    _same_bits([r["draws"] for r in ranks])
    got = ranks[0]["draws"].numpy().astype(np.float64)
    exact = draw.astype(np.float64).mean(0)
    scale = float(np.abs(draw).max()) / 127
    assert (np.abs(got - exact) <= scale * (1 + 1e-6)).all()
    stderr = 0.5 * scale / np.sqrt(ranks_lib.COMPRESS_DRAWS)
    err = got.mean(0) - exact
    assert (np.abs(err) <= 6 * stderr).all()
    assert abs(err.mean()) <= 4 * stderr / np.sqrt(err.size)


def test_list_form_and_pass_through(ranks):
    for r in ranks:
        assert r["pass_through"] is True
        for got, k in zip(r["list"], r["stochastic"]):
            assert torch.equal(got, r["stochastic"][k])


def test_bytes_sent_per_leaf(ranks):
    per_rank = ranks_lib.compression_inputs()["per_rank"]
    log = ranks[0]["log"]
    assert [x["kind"] for x in log] == ["max", "sum"] * len(per_rank)
    for (mx, sm), v in zip(zip(log[::2], log[1::2]), per_rank.values()):
        assert mx["bytes"] == 4
        assert sm["bytes"] == 4 * v[0].size


def test_compress_grads_is_parsed_and_read_nowhere():
    """``--compress-grads`` parses as the reference's (``store_true``,
    repro/launch/train.py:83), and, as there, no line of the launcher reads
    it."""
    import os
    from repro_torch.launch import train as ttrain
    assert ttrain.parse_args(["--compress-grads"]).compress_grads is True
    assert ttrain.parse_args([]).compress_grads is False
    for path in ("repro/launch/train.py", "repro_torch/launch/train.py"):
        with open(os.path.join(torch_ranks.REPO, "src", path)) as f:
            assert "compress_grads" not in f.read()
