"""Tensor parallelism over "model" for the transformer families
(``repro_torch.models.tensor_parallel``, ``launch.mesh.make_mesh``,
``launch.sharding.shard_tree`` / ``gather_tree``), on the CPU.

Gloo ranks of a (data, model) mesh run the reduced configurations of
``torch_tp_cases`` and are held against the whole model on one rank, in
fp32.  Measured (the largest over the cases and the (1, 2), (2, 2), (1, 4)
meshes): hidden states and prefill logits 7.4e-7 of their largest entry
(tolerance 1e-5), the loss and the step metrics 1.6e-7 relative
(tolerance 1e-6), parameters after two steps 7.3e-5 of each leaf's
largest entry (tolerance 2e-4: Adam's first steps divide each gradient
by its own size, so a bias entry whose gradient is a sum of tiny,
differently ordered terms moves by its rounding), initial parameters and
greedy tokens equal.  The split sums partial products over ranks, so the
sums run in another order: no bit-for-bit equality is claimed there.
Replicated leaves (norm scales, ``b_down``) are bit-identical across a
model group.

Two cases of the rules are awkward by design, and covered:
  * the rules split columns whenever the column count divides, not heads:
    the reduced GQA config (4 heads over 2 KV heads, hd 16) at model = 4
    splits ``wk``/``wv`` mid-head (each rank gathers them and takes its KV
    head), and ``mid_head`` (6 heads) at model = 4 splits ``wq`` a head and
    a half a rank (every rank then attends with every head, as internvl2-1b's
    14 heads would);
  * a vocab that does not divide (granite-3-8b's 49,155, internvl2-1b's
    151,655) leaves a table of >= 2^22 elements to the generic rule, which
    splits it on d: ``d_table`` (4,099 x 1,024).

Against the JAX package: ``repro``'s jitted train step on a (2, 2) mesh of
four forced host devices under ``param_specs(model_size=2)`` and
``set_activation_sharding``, from the same weights (``params_from_jax``).
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
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_tp_cases as cases
from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.train import init_train_state as jax_init_train_state
from repro.train import restore_tree as jax_restore_tree
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (
    param_specs,
    shard_slices,
    shard_tree,
    sharded_flags,
    spec_leaves,
)
from repro_torch.models import build_model, transformer
from repro_torch.models.layers import head_split
from repro_torch.models.zoo import tensor_parallel
from repro_torch.train import load_checkpoint
from repro_torch.train.optimizer import leaves

_ROOT = Path(__file__).resolve().parents[1]
_MESHES = [(1, 2), (2, 2), (1, 4)]
_ENV = {"PYTHONPATH": f"{_ROOT / 'src'}:{_ROOT / 'tests'}", "PATH": "/usr/bin:/bin:/usr/local/bin",
        "OMP_NUM_THREADS": "1"}


def _spawn(argv_of_rank, world: int, timeout: float = 240) -> list[str]:
    """``world`` Python processes (``argv_of_rank(rank)``); their stdout.
    Every process is killed on the way out."""
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(rank)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=_ROOT, env=_ENV)
             for rank in range(world)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
        return outs
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def _fake_mesh(model: int, rank: int = 0, data: int = 1) -> Mesh:
    """One rank's view of a (data, model) mesh, without process groups:
    enough to slice."""
    return Mesh(("data", "model"), (data, model), (rank // model, rank % model))


# ------------------------------------------------------ the whole model's shapes
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", sorted(tconfigs.all_configs()))
def test_shard_round_trip_at_full_shapes(name, model):
    """Every configuration's full-size parameters under ``FakeTensorMode``:
    the ranks' blocks of each leaf (``shard_tree``) tile it along the one
    dim "model" splits and, put back together in rank order, have its
    shape; every model draws exactly those blocks (``init_params`` under
    ``tp``), the ssm and hybrid families (RWKV-6's ``tm/Wv`` split on its
    input dim, Mamba2's ``in_proj`` across its segments) too."""
    cfg = tconfigs.get_config(name)
    with FakeTensorMode():
        whole = build_model(cfg, "cpu").init_params(0)
        specs = param_specs(whole, model)
        per_rank = [shard_tree(whole, specs, _fake_mesh(model, r)) for r in range(model)]
        drawn = build_model(cfg, "cpu", tp=_fake_mesh(model, 1)).init_params(0)
        flags = sharded_flags(specs)
        for j, (leaf, spec) in enumerate(zip(leaves(whole), spec_leaves(specs))):
            blocks = [leaves(t)[j] for t in per_rank]
            dims = [d for d, e in enumerate(spec) if e == "model"]
            assert flags[j] == bool(dims)
            if not dims:
                assert all(b is leaf for b in blocks)
                continue
            (d,) = dims
            spans = [shard_slices(tuple(leaf.shape), spec, _fake_mesh(model, r))[d]
                     for r in range(model)]
            assert [s.start for s in spans] == [i * leaf.shape[d] // model for i in range(model)]
            assert spans[-1].stop == leaf.shape[d]
            assert tuple(torch.cat(blocks, d).shape) == tuple(leaf.shape)
            assert tuple(leaves(drawn)[j].shape) == tuple(blocks[1].shape)
    assert len(leaves(drawn)) == len(leaves(whole))
    assert [tuple(p.shape) for p in leaves(drawn)] == [tuple(b.shape) for b in leaves(per_rank[1])]


def test_awkward_splits_are_the_ones_named():
    """The cases this file leans on are what the docstring says they are."""
    for model, name, want in [(4, "granite", "kv gathered"), (2, "mid_head", "heads"),
                              (4, "mid_head", "whole"), (2, "d_table", "d"), (4, "d_table", "d"),
                              (4, "olmo", "vocab")]:
        cfg = cases.CASES[name]()
        tp = tensor_parallel(cfg, _fake_mesh(model))
        split = head_split(transformer.attn_config(cfg), tp)
        if want == "kv gathered":
            assert split == ((0, 1), (0, 1))
            assert tp.leaf_split["attn/wk"] == ((64, 32), 1)  # 8 columns a rank, half a head
        elif want == "heads":
            assert split == ((0, 3), (0, 1))
        elif want == "whole":
            assert split is None and tp.leaf_split["attn/wq"] == ((64, 96), 1)
        elif want == "d":
            assert tp.leaf_split["table"] == ((4099, 1024), 1)
        else:
            assert tp.leaf_split["table"] == ((512, 64), 0)


# ------------------------------------------------------------- gloo ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> each rank's results; the three meshes run at once."""
    tmp = tmp_path_factory.mktemp("tp")
    procs, out = {}, {}
    for data, model in _MESHES:
        world = data * model
        stem = tmp / f"out{data}{model}"
        procs[(data, model)] = [
            subprocess.Popen([sys.executable, str(_ROOT / "tests" / "torch_tp_cases.py"),
                              str(r), str(world), str(tmp / f"store{data}{model}"), str(stem),
                              str(data), str(model)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=_ROOT, env=_ENV)
            for r in range(world)]
    try:
        for mesh, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=240)
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


def _reference(name: str) -> dict:
    """The whole model on one rank, on the whole batch."""
    if name not in _REF:
        cfg = cases.CASES[name]()
        got = cases.outputs(cfg, build_model(cfg, "cpu"), cases.batch_of(cfg),
                            slice(0, cases.BATCH))
        _REF[name] = {k: (v if isinstance(v, list) else v.numpy()) for k, v in got.items()}
    return _REF[name]


def _rows(results, mesh, name, key):
    """``key`` of every data group, in row order (each group's first rank)."""
    data, model = mesh
    return np.concatenate([results[d * model][f"{name}/{key}"] for d in range(data)])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_PARAMS = [(m, n) for m in _MESHES for n in cases.CASES]
_IDS = [f"{d}x{m}-{n}" for (d, m), n in _PARAMS]


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_forward_and_loss_equal_one_rank(ranks, mesh, name):
    """Hidden states, prefill logits and the loss (the data groups' mean)
    equal the whole model's on one rank in fp32; the initial parameters,
    put back together, equal its draw bit for bit."""
    ref, got = _reference(name), ranks[mesh]
    assert _rel(_rows(got, mesh, name, "hidden"), ref["hidden"]) < 1e-5
    if "prefill" in ref:
        assert _rel(_rows(got, mesh, name, "prefill"), ref["prefill"]) < 1e-5
    assert _rel(got[0][f"{name}/loss"], ref["loss"]) < 1e-6
    for j, want in enumerate(ref["init"]):
        assert np.array_equal(got[0][f"{name}/init/{j}"], want.numpy())


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_two_clipped_steps_equal_one_rank(ranks, mesh, name):
    """Two fp32 steps with a clip of 1e-3 (engaged: the norm is about
    1.9-10.1): the losses and global norms, and every parameter after them,
    equal the whole model's steps on one rank.  The norm adds the split
    leaves' squares over the model group and the replicated ones once;
    counted otherwise the clip scale, and with it every update, differs."""
    ref, got = _reference(name), ranks[mesh]
    assert (ref["metrics"][:, 1] > 10 * cases.OPT.grad_clip).all()
    assert _rel(got[0][f"{name}/metrics"], ref["metrics"]) < 1e-6
    for j, want in enumerate(ref["params"]):
        assert _rel(got[0][f"{name}/params/{j}"], want.numpy()) < 2e-4, j


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_replicated_leaves_bit_identical_across_model_group(ranks, mesh, name):
    """Norm scales and ``b_down`` (the leaves no rule splits) are the same
    bits on every rank of a model group after two steps."""
    data, model = mesh
    got = ranks[mesh]
    for r in range(data * model):
        first = got[(r // model) * model][f"{name}/replicated"]
        assert np.array_equal(got[r][f"{name}/replicated"], first)
    if name in ("granite", "hubert"):  # rms scales; layer norms and biases
        assert got[0][f"{name}/replicated"].size > 0


@pytest.mark.parametrize("mesh,name", [(m, n) for m, n in _PARAMS if n != "hubert"],
                         ids=[i for i, (m, n) in zip(_IDS, _PARAMS) if n != "hubert"])
def test_greedy_tokens_equal_one_rank(ranks, mesh, name):
    """``greedy_generate`` on every rank of the mesh gives the whole model's
    tokens (the logits put together over the vocab; each token the model
    group's first rank's argmax, broadcast)."""
    got = ranks[mesh]
    data, model = mesh
    assert np.array_equal(_rows(got, mesh, name, "greedy"), _reference(name)["greedy"])
    for r in range(data * model):
        assert np.array_equal(got[r][f"{name}/greedy"], got[(r // model) * model][f"{name}/greedy"])


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
    set_activation_sharding(P(("data",), "model", None), dict(mesh.shape))
    step = jax.jit(make_train_step(model, OptConfig(**inputs["opt"]), {"dtype": jnp.float32}))
    losses = []
    with mesh:
        params = jax.device_put(params, named(mesh, param_specs(params, model_size=2)))
        opt_state = init_opt_state(params)
        batch = {"tokens": jax.device_put(jnp.asarray(inputs["tokens"]),
                                          NamedSharding(mesh, P("data", None)))}
        for _ in range(2):
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
    set_activation_sharding(None)
    print("RESULT " + json.dumps(losses))
""")

_PORT_STEP = textwrap.dedent("""
    import json, pickle, sys
    sys.modules["jax"] = None
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _mean_over
    from repro_torch.models import build_model, params_from_jax
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
    losses = []
    for _ in range(2):
        params, state, m = step(params, state, {"tokens": tokens})
        loss = m["loss"].detach().clone()
        dist.all_reduce(loss, group=group)
        losses.append(float(loss / 2))
    print("RESULT " + json.dumps(losses))
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-3-8b", "rwkv6-3b", "zamba2-2.7b"])
def test_two_by_two_losses_equal_jax_sharded_step(tmp_path, arch):
    """The port's (2, 2) steps against ``repro``'s jitted train step on a
    (2, 2) mesh of forced host devices under the same rules, from the same
    weights, fp32, no weight decay: both losses to 1e-5 relative (measured
    at most 1.5e-7), the recurrent families (``tests/test_torch_tp_
    recurrent.py``) too."""
    cfg = jconfigs.get_config(arch).reduced()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_init_train_state(jax_build(cfg), jax.random.PRNGKey(3))[0])
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps({"arch": arch, "params": params, "tokens": tokens,
                                   "opt": opt}))
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_STEP, str(path)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=_ROOT, env={**_ENV, "JAX_PLATFORMS": "cpu"})
    try:
        outs = _spawn(lambda r: ["-c", _PORT_STEP, str(r), "4", str(tmp_path / "store"),
                                 str(path)], 4)
        out, err = jax_proc.communicate(timeout=240)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
        jax_proc.wait(timeout=30)
    want = _result(out)
    for got in map(_result, outs):
        assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("RESULT "):])


# ------------------------------------------------- checkpoints under the split
_LAUNCH = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch import mesh as launch_mesh, train as launcher
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.models.convert import train_state_to_jax_layout
    from repro_torch.models.zoo import tensor_parallel
    from repro_torch.configs import get_config

    rank, world, store, ckpt, dump, steps, model_axis = sys.argv[1:8]
    dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                            world_size=int(world))
    argv = ["--arch", "olmo-1b", "--reduced", "--steps", steps, "--batch", "4", "--seq", "24",
            "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    if int(world) == 4:  # the production mesh's path, on a (2, 2) stand-in for (16, 16)
        launch_mesh.production_axes = lambda multi_pod=False: {"data": 2, "model": 2}
        argv += ["--mesh", "prod"]
    else:
        argv += ["--resume", "--model-axis", model_axis]
    out = launcher.run(launcher.parse_args(argv))
    mesh = launch_mesh.make_mesh((int(world) // int(model_axis), int(model_axis)),
                                 ("data", "model"), "cpu")
    specs = tensor_parallel(get_config("olmo-1b").reduced(), mesh).specs
    state = gather_tree({"params": out["params"], "opt": out["opt"]},
                        {"params": specs, "opt": {"m": specs, "v": specs, "step": ()}}, mesh)
    if int(rank) == 0:
        flat = {}
        def walk(node, prefix):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], prefix + (k,))
            elif node is not None:
                flat["/".join(prefix)] = np.asarray(node)
        walk(train_state_to_jax_layout(state), ())
        np.savez(dump, **flat)
    print("RESULT " + json.dumps({"start": out["start"], "losses": out["losses"]}))
    dist.destroy_process_group()
""")


def test_checkpoint_saved_on_two_by_two_resumes_on_one_by_two(tmp_path):
    """The twin of ``tests/test_launch.py::test_elastic_shrink_restart_subprocess``:
    the launcher trains reduced olmo-1b two steps on a (2, 2) mesh through
    ``--mesh prod`` (its axes patched to (2, 2)) and saves; the checkpoint
    is the JAX layout of the whole model, equal to the (2, 2) ranks' blocks
    put back together, and ``repro.train.restore_tree`` reads it; a (1, 2)
    run resumes from it and steps.  Its losses are those of the launcher at
    a world of one, to bf16 rounding (measured 1.9e-5 relative; tolerance 2e-3)."""
    ckpt = tmp_path / "ckpt"
    run = lambda world, steps, model_axis, dump: _spawn(
        lambda r: ["-c", _LAUNCH, str(r), str(world), str(tmp_path / f"store{world}"),
                   str(ckpt), str(tmp_path / dump), str(steps), str(model_axis)], world)
    first = [_result(o) for o in run(4, 2, 2, "saved.npz")]
    step, flat = load_checkpoint(str(ckpt))
    assert step == 2
    saved = np.load(tmp_path / "saved.npz")
    assert sorted(flat) == sorted(saved.files)
    for key in flat:
        assert np.array_equal(flat[key], saved[key]), key
    cfg = jconfigs.get_config("olmo-1b").reduced()
    template = dict(zip(("params", "opt"), jax_init_train_state(jax_build(cfg),
                                                                jax.random.PRNGKey(0))))
    restored = jax_restore_tree(template, flat)
    assert all(np.array_equal(np.asarray(a), flat[k]) for k, a in _paths(restored))
    second = [_result(o) for o in run(2, 3, 2, "resumed.npz")]
    assert all(r == first[0] for r in first) and all(r == second[0] for r in second)
    assert second[0]["start"] == 2 and len(second[0]["losses"]) == 1
    from repro_torch.launch import train as launcher
    one = launcher.run(launcher.parse_args(
        ["--arch", "olmo-1b", "--reduced", "--steps", "3", "--batch", "4", "--seq", "24",
         "--device", "cpu"]))
    got = first[0]["losses"] + second[0]["losses"]
    assert np.allclose(got, one["losses"], rtol=2e-3, atol=0), (got, one["losses"])


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    elif tree is not None:
        yield "/".join(prefix), tree
