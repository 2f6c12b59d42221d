"""The port's first bf16 gradients against the JAX package's own, on the CPU
(``tools/bf16_reference.py`` at the reduced size): rwkv6-3b, zamba2-2.7b
and olmo-1b reduced, the JAX weights of ``PRNGKey(seed)`` carried across,
``TokenPipeline(batch=4, seq=64, seed=seed)``'s first batch, ``loss_fn``
with remat on, seeds 0-3.

bf16 rounding moves these models' first gradient by the model's own
conditioning: the JAX package's bf16 gradient lies 0.0213-3.2869 of its
fp32 norm from its fp32 one at these seeds (rwkv6-3b), the port's
0.0214-1.1764.  The port is at fault only where it moves further than the
reference: its bf16 gradient must lie no further from its own fp32 gradient
than twice the JAX package's does from its (the same-weights factor of
``chip_smoke.py``'s phases 58 and 60).

Where rounding stays small, the two packages' fp32 gradients agree to
``_GRAD_TOL`` (as ``tests/test_torch_rwkv6.py`` holds them).  At rwkv6-3b's
seed 2 the reduced model is ill-conditioned in fp32 too: 2 of its 56
leaves miss ``_GRAD_TOL`` by up to 2.36e-4 of the leaf's largest entry.
There the float64 gradient (the port's model with every fp32 read as
float64, in a process of its own) decides: the port's fp32 lies 2.09e-6 of
the float64 norm from it, 2.61e-5 of a leaf's largest entry at worst, the
JAX package's fp32 1.61e-5 and 2.10e-4; the port must lie no further than
the reference.  About 60 s in one worker (58 s in a run of the whole
suite on six).
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import bf16_reference as ref  # noqa: E402

from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

_NAMES = ("rwkv6-3b", "zamba2-2.7b", "olmo-1b")
_SEEDS = range(4)
_BATCH, _SEQ = 4, 64
_FACTOR = 2.0
_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_torch_rwkv6.py's
_ILL = {("rwkv6-3b", 2)}  # fp32 itself rounds past _GRAD_TOL here (above)


@pytest.fixture(scope="module")
def jax_grad():
    """One jitted ``jax.grad`` a configuration and dtype: the seeds share
    its compilation.  The port runs on one thread meanwhile (its reduced
    models are a few hundred small ops a step)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = {}

    def get(name, jm, dtype):
        if (name, dtype) not in cache:
            cache[name, dtype] = jax.jit(jax.grad(lambda p, t: jm.loss_fn(
                p, {"tokens": t}, dtype=dtype, remat=True)))
        return cache[name, dtype]

    yield get
    torch.set_num_threads(threads)


def _four(name, seed, jax_grad):
    jcfg, tcfg = ref._configs(name, None, True)
    names = ref._names(tcfg)
    tokens = ref._batches(tcfg, _BATCH, _SEQ, seed)[0]
    jm, jp = ref._jax_params(jcfg, seed)
    out = {}
    for key, dt in (("jax_bf16", jnp.bfloat16), ("jax_fp32", jnp.float32)):
        g = jax_grad(name, jm, dt)(jp, jnp.asarray(tokens.numpy()))
        out[key] = [torch.from_numpy(np.array(a)) for a in
                    ref._port_order(tcfg, ref._jax_flat(g), names)]
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    model = build_model(tcfg, "cpu")
    for key, dt in (("port_bf16", torch.bfloat16), ("port_fp32", torch.float32)):
        _, out[key] = ref._port_grads(model, params, tokens, dt, {})
    return names, out


def _off(a, b) -> float:
    """``a``'s distance from ``b`` over ``b``'s global norm."""
    d = sum(float(torch.sum(torch.square(x.double() - y.double()))) for x, y in zip(a, b))
    n = sum(float(torch.sum(torch.square(y.double()))) for y in b)
    return math.sqrt(d / n)


def _worst_leaf(got, want) -> float:
    return max(float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("name", _NAMES)
def test_port_bf16_rounds_no_more_than_twice_the_reference(name, seed, jax_grad):
    names, g = _four(name, seed, jax_grad)
    port = _off(g["port_bf16"], g["port_fp32"])
    want = _off(g["jax_bf16"], g["jax_fp32"])
    assert port <= _FACTOR * want, (port, want)
    if (name, seed) in _ILL:
        return
    for leaf, a, b in zip(names, g["port_fp32"], g["jax_fp32"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=leaf, **_GRAD_TOL)


def test_ill_conditioned_seed_port_fp32_is_nearer_float64_than_the_reference(
        jax_grad, tmp_path):
    """rwkv6-3b reduced at seed 2, where the two fp32 gradients miss
    ``_GRAD_TOL``: against the float64 gradient the port's fp32 lies no
    further than the JAX package's, globally and at its worst leaf."""
    (name, seed), = _ILL
    _, g = _four(name, seed, jax_grad)
    _, f64 = ref._f64(name, None, seed, True, _BATCH, _SEQ, str(tmp_path))
    assert _off(g["port_fp32"], f64) <= _off(g["jax_fp32"], f64)
    assert _worst_leaf(g["port_fp32"], f64) <= _worst_leaf(g["jax_fp32"], f64)
