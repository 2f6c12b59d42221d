"""MoE under data parallelism: two gloo ranks, each with half of a batch,
against the JAX package's ``moe_ffn`` on the whole batch, as its SPMD host
mesh computes it.

The aux loss e·Σ_e frac_e·mean(P_e) is a product of two batch means, so
the mean of the ranks' own aux losses is not the global batch's; and the
replica plan is the global batch's expert histogram.  With the launcher's
data-parallel group, ``moe_ffn`` adds the choices' counts and the router
probabilities' sums over the ranks before the product, and plans the
replica slots from the global counts with global choice indices.  Averaged
as the launcher averages (the losses and the gradients, a SUM all_reduce
over the world size), the aux and the router's gradient equal the JAX
package's aux and ``jax.grad`` on the whole batch in fp32, to 1e-6 of the
largest entry (sums in another order; measured about 1e-7), and each rank's
output rows equal the whole batch's to the layer's 2e-4
(``tests/test_torch_moe.py``).  Without the group each rank's aux is its
own half's: the same comparison is off by more than 100 times the
tolerance."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.models import moe as jm

_ROOT = Path(__file__).resolve().parents[1]
_NAME, _CF, _EXTRA = "qwen2-moe-a2.7b", 1.25, 8  # the launcher's capacity and replica slots
_TOL = 1e-6

_RANK = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # the port runs without JAX
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models import moe

    rank, world, store, inputs, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    data = np.load(inputs)
    cfg = configs.get_config(data["name"].item()).reduced()
    x = torch.from_numpy(data["x"])
    rows = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
    res = {}
    for tag, group in (("global", dist.group.WORLD), ("local", None)):
        blk = {}
        for key in data.files:
            if key.startswith("blk/"):
                *path, leaf = key.split("/")[1:]
                node = blk
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(data[key]).requires_grad_(True)
        y, aux = moe.moe_ffn(blk, x[rows], cfg, float(data["cf"]), int(data["extra"]),
                             group=group)
        res[tag + "_out"] = y.detach().numpy()
        aux.backward()
        # averaged as the launcher averages the losses and the gradients
        grad = blk["router"].grad.clone()
        dist.all_reduce(grad)
        loss = aux.detach().clone()
        dist.all_reduce(loss)
        res[tag + "_aux"] = (loss / world).numpy()
        res[tag + "_grad"] = (grad / world).numpy()
    np.savez(out + f".{rank}.npz", **res)
    dist.destroy_process_group()
""")


def _gloo_ranks(inputs: Path, out: Path, world: int) -> None:
    env = {"PYTHONPATH": str(_ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "OMP_NUM_THREADS": "1"}
    store = out.parent / "store"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(world), str(store),
                               str(inputs), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=_ROOT, env=env)
             for rank in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def _flat(tree, prefix="blk") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val, np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_two_gloo_ranks_aux_and_router_gradient_equal_jax_whole_batch(tmp_path, seed):
    cfg = jconfigs.get_config(_NAME).reduced()
    params = jax_build(cfg).init_params(jax.random.PRNGKey(seed))
    blk = jax.tree.map(lambda a: np.asarray(a[0], np.float32), params["blocks"])
    rng = np.random.default_rng(seed)
    # four sequences of 24 tokens, the second half's router inputs shifted so
    # that the halves route differently
    x = rng.normal(size=(4, 24, cfg.d_model)).astype(np.float32)
    x[2:] += rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, name=np.array(_NAME), cf=np.array(_CF),
             extra=np.array(_EXTRA), **_flat(blk))
    _gloo_ranks(tmp_path / "in.npz", tmp_path / "out", 2)
    got = np.load(tmp_path / "out.0.npz")

    def aux_of(router):
        return jm.moe_ffn({**blk, "router": router}, jnp.asarray(x), cfg, _CF, _EXTRA)[1]

    want_out = np.asarray(jm.moe_ffn(blk, jnp.asarray(x), cfg, _CF, _EXTRA)[0])
    for rank in range(2):
        rows = np.load(tmp_path / f"out.{rank}.npz")["global_out"]
        np.testing.assert_allclose(rows, want_out[2 * rank:2 * rank + 2], rtol=2e-4, atol=2e-4)
    want_aux, want_grad = jax.value_and_grad(aux_of)(jnp.asarray(blk["router"]))
    want_aux, want_grad = float(want_aux), np.asarray(want_grad)
    scale = np.abs(want_grad).max()
    assert abs(float(got["global_aux"]) - want_aux) <= _TOL * abs(want_aux)
    assert np.abs(got["global_grad"] - want_grad).max() <= _TOL * scale
    # each rank's own half: the fault the group repairs, far above the tolerance
    assert abs(float(got["local_aux"]) - want_aux) > 100 * _TOL * abs(want_aux)
    assert np.abs(got["local_grad"] - want_grad).max() > 100 * _TOL * scale
