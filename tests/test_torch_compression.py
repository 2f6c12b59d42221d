"""The port's int8 gradient compression (``repro_torch.train.compression``)
against the JAX package's ``repro.train.compression`` under ``shard_map``,
on the CPU: at world one in this process (the port on its one-rank gloo
group), and at world four, the port on four gloo processes and the JAX
package on four host devices forced in a subprocess of its own.

Against the JAX functions run op by op (``shard_map`` not jitted) every
result is equal bit for bit: both packages run the same fp32 operations in
the same order, round half to even, and sum the int8 grid exactly in int32.
Jitted, XLA fuses and reorders (it computes the mean as ``total * (scale /
n)`` where the function writes ``total * scale / n``), so the 50-step
error-feedback loop, which runs the JAX side jitted to stay fast, holds
each step's mean and residual, from the port's residual of the step
before, to 1e-6 of the gradient's largest entry (measured: 2.4e-7 at a
largest entry of 2.3, one fp32 ulp at the entries that differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.mapreduce.shuffle import shard_map
from repro.train import compression as jc
from repro_torch.train import compression as tc
from repro_torch.train import optimizer as topt
from torch_cases import gloo_ranks_and_jax

_WORLD = 4


def _one(fn, jit: bool = False):
    """``fn`` under ``shard_map`` on one device, every input replicated;
    op by op unless ``jit``."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    out = shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False)
    return jax.jit(out) if jit else out


def _grad(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,shape,scale", [(0, (64,), 1.0), (1, (7, 33), 1e-3),
                                              (2, (3, 4, 5), 50.0)])
def test_quantize_and_dequantize_match_jax(seed, shape, scale):
    g = _grad(seed, shape, scale)
    g.flat[0] = 0.5 * np.abs(g).max() / 127.0 * 127.0  # an entry on a half step
    want_q, want_s = jc.quantize(jnp.asarray(g))
    got_q, got_s = tc.quantize(torch.from_numpy(g))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.item() == float(want_s)
    np.testing.assert_array_equal(tc.dequantize(got_q, got_s).numpy(),
                                  np.asarray(jc.dequantize(want_q, want_s)))


def test_round_is_half_to_even_as_jnp_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_psum_world_one_matches_jax(seed):
    g = _grad(seed, (5, 40), 3.0)
    r = _grad(seed + 10, (5, 40), 0.01)
    want = _one(lambda gg, rr: jc.compressed_psum(gg, rr, "x"))(jnp.asarray(g), jnp.asarray(r))
    got = tc.compressed_psum(torch.from_numpy(g), torch.from_numpy(r))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressed_psum_error_feedback():
    """``tests/test_train_serve.py::test_compressed_psum_error_feedback`` on
    the port: over 50 steps at world one the accumulated compressed sum
    tracks the true sum (the residual telescopes); each step's mean and
    residual equal the jitted JAX function's on the same residual to 1e-6
    of the gradient's largest entry (see the module's docstring)."""
    step = _one(lambda gg, rr: jc.compressed_psum(gg, rr, "x"), jit=True)
    g = _grad(0, 64)
    tr = torch.zeros(64)
    acc_true = np.zeros(64, np.float64)
    acc_comp = np.zeros(64, np.float64)
    for _ in range(50):
        want, jr = step(jnp.asarray(g), jnp.asarray(tr.numpy()))
        out, tr = tc.compressed_psum(torch.from_numpy(g), tr)
        tol = 1e-6 * np.abs(g).max()
        assert np.abs(tr.numpy() - np.asarray(jr)).max() <= tol
        assert np.abs(out.numpy() - np.asarray(want)).max() <= tol
        acc_true += g.astype(np.float64)
        acc_comp += out.numpy().astype(np.float64)
    rel = np.linalg.norm(acc_comp - acc_true) / np.linalg.norm(acc_true)
    assert rel < 0.01, rel


def _tree(seed: int) -> dict:
    """A params-shaped tree: dicts (keys out of sorted order) and a list."""
    return {"w": _grad(seed, (6, 5), 2.0),
            "blocks": [{"b": _grad(seed + 1, (4,)), "a": _grad(seed + 2, (3, 3), 1e-2)},
                       {"b": _grad(seed + 3, (4,)), "a": _grad(seed + 4, (3, 3))}],
            "bias": _grad(seed + 5, (2,), 0.1)}


def test_compressed_tree_psum_world_one_matches_jax():
    """One step from non-zero residuals, op by op, every leaf bit for bit;
    ``init_residuals`` gives fp32 zeros in the tree's shapes."""
    grads, res = _tree(3), jax.tree.map(lambda a: a * 1e-3, _tree(9))
    tgrads = topt.map_tree(torch.from_numpy, grads)
    zeros = tc.init_residuals(tgrads)
    assert [tuple(x.shape) for x in topt.leaves(zeros)] == [
        x.shape for x in jax.tree.leaves(jc.init_residuals(grads))]
    assert all(x.dtype == torch.float32 and not x.any() for x in topt.leaves(zeros))
    want = _one(lambda gg, rr: jc.compressed_tree_psum(gg, rr, "x"))(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    got = tc.compressed_tree_psum(tgrads, topt.map_tree(torch.from_numpy, res))
    for tree in got:
        assert list(tree) == list(grads)  # the tree keeps its shape and key order
        assert [list(b) for b in tree["blocks"]] == [["b", "a"], ["b", "a"]]
    for a, b in zip(topt.leaves(got[0]) + topt.leaves(got[1]),
                    jax.tree.leaves(want[0]) + jax.tree.leaves(want[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------- world four
# each rank's gradients and residuals: rank r takes row r of arrays drawn
# for all ranks at once, in either package
_INPUTS = r"""
import numpy as np

def inputs(world):
    rng = np.random.default_rng(4)
    g = (rng.normal(size=(world, 3, 50)) * rng.uniform(0.1, 10, (world, 1, 1))).astype(np.float32)
    r = (rng.normal(size=(world, 3, 50)) * 0.01).astype(np.float32)
    tree = {"w": (rng.normal(size=(world, 8, 4)) * 2).astype(np.float32),
            "blocks": [{"b": rng.normal(size=(world, 5)).astype(np.float32)},
                       {"b": (rng.normal(size=(world, 5)) * 1e-3).astype(np.float32)}]}
    return g, r, tree

def flat(tree, order):
    return [np.asarray(x, np.float32).ravel().tolist() for x in order(tree)]
"""

_JAX_SNIPPET = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.mapreduce.shuffle import shard_map
from repro.train import compression as jc
{inputs}
g, r, tree = inputs({world})
mesh = Mesh(np.array(jax.devices()), ("x",))
# each device holds its row [1, ...]; the mean comes back replicated
psum = shard_map(lambda gg, rr: jc.compressed_psum(gg, rr, "x"), mesh=mesh,
                 in_specs=(P("x"), P("x")), out_specs=(P(), P("x")), check_vma=False)
mean, res = psum(jnp.asarray(g), jnp.asarray(r))
tree_psum = shard_map(lambda gg, rr: jc.compressed_tree_psum(gg, rr, "x"), mesh=mesh,
                      in_specs=(P("x"), P("x")), out_specs=(P(), P("x")), check_vma=False)
tg = jax.tree.map(jnp.asarray, tree)
tmean, tres = tree_psum(tg, jc.init_residuals(tg))
out = dict(mean=flat(mean[:1], lambda x: [x]),
           res=[flat(res[i:i + 1], lambda x: [x]) for i in range({world})],
           tmean=flat(jax.tree.map(lambda a: a[:1], tmean), jax.tree.leaves),
           tres=[flat(jax.tree.map(lambda a: a[i:i + 1], tres), jax.tree.leaves)
                 for i in range({world})])
print("RESULT " + json.dumps(out))
"""

_PORT_SNIPPET = r"""
import json, sys
sys.modules["jax"] = None  # the port runs without JAX
import torch, torch.distributed as dist
from repro_torch.train import compression as tc
from repro_torch.train.optimizer import leaves, map_tree
{inputs}
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
g, r, tree = inputs(world)
mean, res = tc.compressed_psum(torch.from_numpy(g[rank:rank + 1]),
                               torch.from_numpy(r[rank:rank + 1]))
mine = map_tree(lambda a: torch.from_numpy(a[rank:rank + 1]), tree)
tmean, tres = tc.compressed_tree_psum(mine, tc.init_residuals(mine))
dist.destroy_process_group()
out = dict(mean=flat(mean, lambda x: [x]), res=flat(res, lambda x: [x]),
           tmean=flat(tmean, leaves), tres=flat(tres, leaves))
print("RESULT " + json.dumps(out))
"""


def test_world_four_matches_jax_on_four_devices():
    """Four ranks with gradients of different scales: each rank's mean is
    the JAX package's, bit for bit, and so is each rank's residual, for a
    tensor and for a tree."""
    got, want = gloo_ranks_and_jax(_PORT_SNIPPET.format(inputs=_INPUTS),
                                   _JAX_SNIPPET.format(world=_WORLD, inputs=_INPUTS), _WORLD)
    for rank, out in enumerate(got):
        assert out["mean"] == want["mean"], rank
        assert out["tmean"] == want["tmean"], rank
        assert out["res"] == want["res"][rank], rank
        assert out["tres"] == want["tres"][rank], rank
    assert want["res"][0] != want["res"][1]  # the ranks' residuals differ
