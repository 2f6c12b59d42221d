"""Sequence parallelism of the residual stream over "model"
(``repro_torch.models.tensor_parallel``: ``TensorParallel.over``,
``enter``, ``leave``, the sequence gather and scatter), on the CPU.

Gloo ranks of a (data, model) mesh run a reduced configuration of each
family (``torch_sp_cases``) at a length that divides the model axis and at
one that does not (30 at model = 4), and are held against the whole model on
one rank in fp32: the stream enters each block as [B_local, S/m, d] where
m divides S and whole otherwise, as the JAX package's ``P(dp, "model",
None)`` splits it; hidden states to 1e-5 of their largest entry, the loss
to 1e-6 relative and every gradient to 1e-4 of its leaf's largest entry
(the tolerances of ``tests/test_torch_tp.py`` and ``tests/
test_torch_tp_recurrent.py``); the replicated leaves' gradients (the norms
a rank applies to its rows, ``b_down``) the same bits on every rank of a
model group.  A prefixed configuration splits the joined
sequence, 6 patches and 10 tokens at model = 4.

Against the JAX package: the recurrent families' (2, 2) train steps equal
``repro``'s jitted step under ``set_activation_sharding(P("data", "model",
None))`` on four forced host devices.
"""
import json
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_sp_cases as cases
from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.train import init_train_state as jax_init_train_state
from repro_torch.models import build_model

_ROOT = Path(__file__).resolve().parents[1]
_MESHES = [(1, 2), (2, 2), (1, 4)]
_ENV = {"PYTHONPATH": f"{_ROOT / 'src'}:{_ROOT / 'tests'}", "PATH": "/usr/bin:/bin:/usr/local/bin",
        "OMP_NUM_THREADS": "1"}
_RUNS = {key: (name, cfg, length) for key, name, cfg, length in cases.cases()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> each rank's results; the three meshes run at once."""
    tmp = tmp_path_factory.mktemp("sp")
    procs, out = {}, {}
    for data, model in _MESHES:
        world = data * model
        procs[(data, model)] = [
            subprocess.Popen([sys.executable, str(_ROOT / "tests" / "torch_sp_cases.py"),
                              str(r), str(world), str(tmp / f"store{data}{model}"),
                              str(tmp / f"out{data}{model}"), str(data), str(model)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=_ROOT, env=_ENV)
            for r in range(world)]
    try:
        for mesh, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-3000:]
            out[mesh] = [dict(np.load(f"{tmp}/out{mesh[0]}{mesh[1]}.{r}.npz"))
                         for r in range(len(ps))]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait(timeout=30)
    return out


_REF = {}


def _reference(key: str) -> dict:
    """The whole model on one rank, on the whole batch."""
    if key not in _REF:
        name, cfg, length = _RUNS[key]
        got = cases.outputs(cfg, build_model(cfg, "cpu"), cases.batch_of(name, cfg, length),
                            slice(0, cases.BATCH))
        _REF[key] = {"loss": got["loss"].numpy(), "hidden": got["hidden"].numpy(),
                     "grads": [g.numpy() for g in got["grads"]], "shapes": got["shapes"]}
    return _REF[key]


def _rows(results, mesh, key, what):
    """``what`` of every data group, in row order (each group's first rank)."""
    data, model = mesh
    return np.concatenate([results[d * model][f"{key}/{what}"] for d in range(data)])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _split(mesh, length) -> bool:
    return length % mesh[1] == 0


_PARAMS = [(m, key) for m in _MESHES for key in _RUNS]
_IDS = [f"{d}x{m}-{key.replace('/', '-')}" for (d, m), key in _PARAMS]


@pytest.mark.parametrize("mesh,key", _PARAMS, ids=_IDS)
def test_stream_enters_each_block_as_this_ranks_rows(ranks, mesh, key):
    """Each block's entry sees [B / data, S / model, d] where the model axis
    divides the stream's length S (a prefix joined on), the whole [B / data,
    S, d] where it does not; the whole model on one rank sees [B, S, d]."""
    ref = _reference(key)["shapes"]
    b, s, d = ref[0]
    assert (ref == (b, s, d)).all()
    want = (b // mesh[0], s // mesh[1] if _split(mesh, s) else s, d)
    for r, got in enumerate(ranks[mesh]):
        shapes = got[f"{key}/shapes"]
        assert len(shapes) == len(ref) and (shapes == want).all(), (r, shapes[:2], want)


@pytest.mark.parametrize("mesh,key", _PARAMS, ids=_IDS)
def test_split_or_whole_equals_one_rank(ranks, mesh, key):
    """Hidden states, the loss (the data groups' mean) and the first
    gradients (the data groups' mean, put back together) equal the whole
    model's on one rank in fp32, the stream split or not."""
    ref, got = _reference(key), ranks[mesh]
    assert _rel(_rows(got, mesh, key, "hidden"), ref["hidden"]) < 1e-5
    assert _rel(got[0][f"{key}/loss"], ref["loss"]) < 1e-6
    for j, want in enumerate(ref["grads"]):
        assert _rel(got[0][f"{key}/grads/{j}"], want) < 1e-4, j


@pytest.mark.parametrize("mesh,key", _PARAMS, ids=_IDS)
def test_replicated_gradients_bit_identical_across_model_group(ranks, mesh, key):
    """The gradients of the leaves no rule splits (norm scales and biases,
    which act on a rank's rows, summed over the group through ``copy``) are
    the same bits on every rank of a model group."""
    data, model = mesh
    got = ranks[mesh]
    for r in range(data * model):
        first = got[(r // model) * model][f"{key}/replicated"]
        assert np.array_equal(got[r][f"{key}/replicated"], first)
    if not key.startswith("olmo"):  # OLMo's LayerNorm has no parameters
        assert got[0][f"{key}/replicated"].size > 0


def test_prefix_joined_before_the_split(ranks):
    """internvl2-1b's reduced config with 6 patches ahead of 10 tokens at
    model = 4: 10 does not divide 4, the joined 16 does, and the stream
    enters each block as 4 of the joined rows."""
    shapes = ranks[(1, 4)][0]["prefixed/16/shapes"]
    assert tuple(shapes[0][:2]) == (cases.BATCH, 4)
    assert cases.PREFIXED[1] % 4 and (cases.PREFIXED[1] + cases.PREFIXED[2]) % 4 == 0


# ------------------------------------------------------- against the JAX package
_JAX_STEP = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.sharding import named, param_specs
    from repro.models import build_model
    from repro.models.layers import set_activation_sharding
    from repro.train import OptConfig, make_train_step
    from repro.train.optimizer import init_opt_state

    inputs = pickle.load(open(sys.argv[1], "rb"))
    cfg = get_config(inputs["arch"]).reduced()
    model = build_model(cfg)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    params = jax.tree.map(jnp.asarray, inputs["params"])
    set_activation_sharding(P("data", "model", None), dict(mesh.shape))
    step = jax.jit(make_train_step(model, OptConfig(**inputs["opt"]), {"dtype": jnp.float32}))
    metrics = []
    with mesh:
        params = jax.device_put(params, named(mesh, param_specs(params, model_size=2)))
        opt_state = init_opt_state(params)
        batch = {"tokens": jax.device_put(jnp.asarray(inputs["tokens"]),
                                          NamedSharding(mesh, P("data", None)))}
        for _ in range(2):
            params, opt_state, m = step(params, opt_state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    set_activation_sharding(None)
    print("RESULT " + json.dumps(metrics))
""")

_PORT_STEP = textwrap.dedent("""
    import json, pickle, sys
    sys.modules["jax"] = None
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _mean_over
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state, leaves

    rank, world, store, path = sys.argv[1:5]
    dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                            world_size=int(world))
    inputs = pickle.load(open(path, "rb"))
    cfg = get_config(inputs["arch"]).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = build_model(cfg, "cpu", tp=mesh)
    params = params_from_jax(cfg, inputs["params"], "cpu", tp=model.tp)
    for p in leaves(params):
        p.requires_grad_(True)
    state = init_opt_state(params)
    group = mesh.group("data")
    step = make_train_step(model, OptConfig(**inputs["opt"]), {"dtype": torch.float32},
                           _mean_over(group))
    i = mesh.index("data")
    tokens = torch.from_numpy(inputs["tokens"])[2 * i:2 * i + 2]
    entries = []
    mod = rwkv6 if cfg.family == "ssm" else mamba2
    name = "_block_apply" if cfg.family == "ssm" else "_mamba_body"
    inner = getattr(mod, name)
    def recorded(cfg_, blk, x, *a, **kw):
        entries.append(list(x.shape))
        return inner(cfg_, blk, x, *a, **kw)
    setattr(mod, name, recorded)
    metrics = []
    for _ in range(2):
        params, state, m = step(params, state, {"tokens": tokens})
        both = torch.stack([m["loss"].detach(), m["grad_norm"].detach()])
        dist.all_reduce(both, group=group)
        metrics.append((both / 2).tolist())
    print("RESULT " + json.dumps({"metrics": metrics, "entry": entries[0]}))
    dist.destroy_process_group()
""")


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_recurrent_two_by_two_steps_equal_jax_sequence_split(tmp_path, arch):
    """The port's (2, 2) steps of the recurrent families, the stream's 16
    positions split two ways between blocks (8 a rank, asserted), against
    ``repro``'s jitted train step on a (2, 2) mesh of forced host devices
    under ``P("data", "model", None)`` and the same rules, from the same
    weights, fp32, no weight decay: both steps' losses and the first
    step's global gradient norm to 1e-5 relative.  The second step's norm
    is not held: Adam's first update divides each gradient by its own size,
    so entries whose gradient is tiny move by its rounding, and the second
    norm of rwkv6-3b lies 1.7e-5 apart between the unsplit port and the
    unsplit JAX step already."""
    cfg = jconfigs.get_config(arch).reduced()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_init_train_state(jax_build(cfg), jax.random.PRNGKey(5))[0])
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps({"arch": arch, "params": params, "tokens": tokens,
                                   "opt": dict(lr=1e-3, warmup_steps=1, total_steps=10,
                                               weight_decay=0.0)}))
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_STEP, str(path)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=_ROOT, env={**_ENV, "JAX_PLATFORMS": "cpu"})
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_STEP, str(r), "4",
                               str(tmp_path / "store"), str(path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=_ROOT, env=_ENV)
             for r in range(4)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
        out, err = jax_proc.communicate(timeout=240)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in procs + [jax_proc]:
            p.kill()
            p.wait(timeout=30)
    want = np.array(_result(out))
    for got in map(_result, outs):
        assert got["entry"] == [2, 8, cfg.d_model]
        held = np.array(got["metrics"])[[0, 0, 1], [0, 1, 0]]
        assert np.allclose(held, want[[0, 0, 1], [0, 1, 0]], rtol=1e-5, atol=0), (got, want)
