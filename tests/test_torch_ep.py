"""Expert parallelism over "model" for the MoE family
(``repro_torch.models.moe`` under ``tensor_parallel.TensorParallel``), on
the CPU.

Gloo ranks of a (data, model) mesh run the cases of ``torch_ep_cases``
(reduced qwen2-moe-a2.7b and qwen3-moe-30b-a3b, 8 experts, top 2, with 0
and 4 replica slots; two awkward cases) and are held against the whole
model on one rank, in fp32, on the (1, 2), (2, 2) and (1, 4) meshes: the
hidden states and layer 0's output to 1e-5 of their largest entry, the
loss, the aux loss and the step metrics to 1e-5 relative, the first step's
gradients to 1e-4 of each leaf's largest entry, the parameters after two
clipped steps to 2e-4 of each leaf's largest entry (Adam's first steps
divide each gradient by its own size, so an entry whose gradient is a sum
of tiny, differently ordered terms moves by its rounding), the initial
parameters, greedy tokens and the dispatch's integers (slot loads, dropped
choices, each replica slot's expert) equal.  The combine sums a token's k
choices as partial sums over the ranks that hold them, so the float sums
run in another order than on one rank: no bit-for-bit equality is claimed
there.  Replicated leaves (norm scales, the router, ``shared_gate``, the
biases) are bit-identical across a model group.

Two cases of the rules are awkward by design, and covered:
  * ``x6``: 6 replica slots at model = 4, where the replica buffer's slot
    dim does not divide; ``constrain_moe_dispatch`` leaves it whole, and
    the group's first rank computes every replica slot (counted once);
  * ``e6``: 6 experts at model = 4, where the experts do not divide; the
    rules split each expert's width (``w_gate``/``w_up`` columns,
    ``w_down`` rows) and every rank runs every slot on its block.

Against the JAX package: ``repro``'s jitted MoE train step with replica
slots on a (2, 2) mesh of four forced host devices under
``param_specs(model_size=2)`` and ``set_activation_sharding``, from the
same weights (``params_from_jax``).
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

import torch_ep_cases as cases
from repro import configs as jconfigs
from repro.launch import sharding as jrules
from repro.models import build_model as jax_build
from repro.train import init_train_state as jax_init_train_state
from repro.train import restore_tree as jax_restore_tree
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import param_specs
from repro_torch.models import build_model
from repro_torch.models.moe import expert_split, fetch_bytes
from repro_torch.models.zoo import tensor_parallel
from repro_torch.train import load_checkpoint
from repro_torch.train.optimizer import leaves

_ROOT = Path(__file__).resolve().parents[1]
_MESHES = [(1, 2), (2, 2), (1, 4)]
_ENV = {"PYTHONPATH": f"{_ROOT / 'src'}:{_ROOT / 'tests'}", "PATH": "/usr/bin:/bin:/usr/local/bin",
        "OMP_NUM_THREADS": "1"}


def _fake_mesh(model: int, rank: int = 0, data: int = 1) -> Mesh:
    """One rank's view of a (data, model) mesh, without process groups."""
    return Mesh(("data", "model"), (data, model), (rank // model, rank % model))


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


# -------------------------------------------------------------- the ownership
@pytest.mark.parametrize("model,name,mode,slots", [
    (2, "qwen2_x4", "experts", [0] * 4 + [1] * 4 + [0, 0, 1, 1]),
    (4, "qwen2_x4", "experts", [0, 0, 1, 1, 2, 2, 3, 3, 0, 1, 2, 3]),
    (4, "x6", "experts", [0, 0, 1, 1, 2, 2, 3, 3] + [0] * 6),
    (2, "e6", "experts", [0, 0, 0, 1, 1, 1, 0, 0, 1, 1]),
    (4, "e6", "width", None),
])
def test_awkward_splits_are_the_ones_named(model, name, mode, slots):
    """Which rank computes each slot, as the docstring says: the experts'
    primary slots by their owner, the replica slots an equal share a rank
    where they divide, all on the first rank where they do not; 6 experts
    at model = 4 run every slot on a quarter of the width."""
    make, extra = cases.CASES[name]
    cfg = make()
    tp = tensor_parallel(cfg, _fake_mesh(model))
    assert expert_split(tp, cfg.n_experts)[0] == mode
    assert tp.slot_ranks(cfg.n_experts, extra) == slots
    if mode == "width":
        assert tp.leaf_split["experts/w_gate"] == ((6, 64, 32), 2)
        assert tp.leaf_split["experts/w_down"] == ((6, 32, 64), 1)
        assert expert_split(tp, cfg.n_experts)[1] == (0, 8)
        assert fetch_bytes(cfg, extra, torch.bfloat16, tp) == 0
    else:
        assert tp.leaf_split["experts/w_up"] == ((cfg.n_experts, 64, 32), 0)
        # each of the three weights' [X, d, f] in bf16
        assert fetch_bytes(cfg, extra, torch.bfloat16, tp) == 3 * extra * 64 * 32 * 2
    # the shared expert's leaves keep their own names, split on d_ff
    assert tp.leaf_split["shared/w_up"] == ((64, 128), 1)


@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_expert_leaves_split_as_the_jax_rules_place_them(arch, model):
    """The port's per-layer [E, d, f] expert leaves (and the router, the
    shared expert, ``shared_gate``) take the JAX rules' spec of the stacked
    [L, E, d, f] leaf without its layer dim, at full size: qwen3's 128
    experts split on the expert dim at every size, qwen2's 60 at 2 and 4,
    and at 16 each expert's width.  The dry run's ``split_params_bytes``
    at model = 16 is what a rank of the split model holds (no FSDP)."""
    jshape = jax.eval_shape(jax_build(jconfigs.get_config(arch)).init_params,
                            jax.random.PRNGKey(0))
    jspec = jrules.param_specs(jshape, model)
    with FakeTensorMode():
        params = build_model(tconfigs.get_config(arch), "cpu").init_params(0)
    pspec = param_specs(params, model)
    names = [("experts", "w_gate"), ("experts", "w_up"), ("experts", "w_down"), ("router",),
             ("shared", "w_up"), ("shared", "w_down"), ("shared", "w_gate"), ("shared_gate",)]
    for path in names:
        jnode, leaf = jspec["blocks"], params["blocks"][0]
        if path[0] not in leaf:
            continue
        for key in path:
            jnode, leaf = jnode[key], leaf[key]
        want = (tuple(jnode) + (None,) * (leaf.dim() + 1))[1:leaf.dim() + 1]
        for blk in pspec["blocks"]:
            node = blk
            for key in path:
                node = node[key]
            assert node == want, (path, node, want)
    experts = pspec["blocks"][0]["experts"]["w_gate"]
    cfg = tconfigs.get_config(arch)
    assert experts == (("model", None, None) if cfg.n_experts % model == 0
                       else (None, None, "model"))
    if model == 16:
        rec = dryrun.reckon_cell(arch, "train_4k", False)
        with FakeTensorMode():
            held = build_model(cfg, "cpu", tp=_fake_mesh(16, data=16)).init_params(0)
        assert rec["split_params_bytes"] == sum(p.numel() * p.element_size()
                                                for p in leaves(held))


# ------------------------------------------------------------- gloo ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> each rank's results; the three meshes run at once."""
    tmp = tmp_path_factory.mktemp("ep")
    procs, out = {}, {}
    for data, model in _MESHES:
        world = data * model
        procs[(data, model)] = [
            subprocess.Popen([sys.executable, str(_ROOT / "tests" / "torch_ep_cases.py"),
                              str(r), str(world), str(tmp / f"store{data}{model}"),
                              str(tmp / f"out{data}{model}"), str(data), str(model)],
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
        make, extra = cases.CASES[name]
        cfg = make()
        got = cases.outputs(cfg, extra, build_model(cfg, "cpu"), slice(0, cases.BATCH))
        _REF[name] = {k: ([t.numpy() for t in v] if isinstance(v, list) else v.numpy())
                      for k, v in got.items()}
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
    """Hidden states, layer 0's output, the aux loss and the loss (the data
    groups' mean) equal the whole model's on one rank in fp32; the initial
    parameters, put back together, equal its draw bit for bit."""
    ref, got = _reference(name), ranks[mesh]
    assert _rel(_rows(got, mesh, name, "hidden"), ref["hidden"]) < 1e-5
    assert _rel(_rows(got, mesh, name, "layer"), ref["layer"]) < 1e-5
    assert _rel(got[0][f"{name}/aux"], ref["aux"]) < 1e-5
    assert _rel(got[0][f"{name}/loss"], ref["loss"]) < 1e-5
    for j, want in enumerate(ref["init"]):
        assert np.array_equal(got[0][f"{name}/init/{j}"], want)


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_dispatch_integers_equal_one_rank(ranks, mesh, name):
    """Layer 0's slot loads (summed over the data groups), dropped choices
    and each replica slot's expert, on every rank, equal one rank's on the
    whole batch bit for bit: rank placement changes no slot a choice
    takes.  The cases overflow their capacity and grant replicas."""
    ref, got = _reference(name), ranks[mesh]
    assert ref["dropped"].item() > 0
    for r in range(mesh[0] * mesh[1]):
        assert np.array_equal(got[r][f"{name}/slot_loads"], ref["slot_loads"])
        assert np.array_equal(got[r][f"{name}/dropped"], ref["dropped"])
        if "slot_expert" in ref:
            assert np.array_equal(got[r][f"{name}/slot_expert"], ref["slot_expert"])
    if "slot_expert" in ref:  # some replica slot serves a granted expert, not the pad E - 1
        assert (ref["slot_expert"][cases.CASES[name][0]().n_experts:]
                != cases.CASES[name][0]().n_experts - 1).any()


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_gradients_and_two_clipped_steps_equal_one_rank(ranks, mesh, name):
    """The first step's gradients (data-group mean, put back together) to
    1e-4 of each leaf's largest entry; two fp32 steps with a clip of 1e-3
    (engaged): the losses and global norms to 1e-5 relative, and every
    parameter after them to 2e-4 of its leaf's largest entry."""
    ref, got = _reference(name), ranks[mesh]
    assert (ref["metrics"][:, 1] > 10 * cases.OPT.grad_clip).all()
    for j, want in enumerate(ref["grads"]):
        assert _rel(got[0][f"{name}/grads/{j}"], want) < 1e-4, j
    assert _rel(got[0][f"{name}/metrics"], ref["metrics"]) < 1e-5
    for j, want in enumerate(ref["params"]):
        assert _rel(got[0][f"{name}/params/{j}"], want) < 2e-4, j


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_replicated_leaves_bit_identical_across_model_group(ranks, mesh, name):
    """The leaves no rule splits (norm scales, the router, ``shared_gate``,
    attention biases) are the same bits on every rank of a model group
    after two steps."""
    data, model = mesh
    got = ranks[mesh]
    assert got[0][f"{name}/replicated"].size > 0
    for r in range(data * model):
        first = got[(r // model) * model][f"{name}/replicated"]
        assert np.array_equal(got[r][f"{name}/replicated"], first)


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_greedy_tokens_equal_one_rank(ranks, mesh, name):
    """``greedy_generate`` on every rank gives the whole model's tokens."""
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
    step = jax.jit(make_train_step(model, OptConfig(**inputs["opt"]),
                                   {"dtype": jnp.float32, **inputs["loss"]}))
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
    step = make_train_step(model, OptConfig(**inputs["opt"]),
                           {"dtype": torch.float32, "group": group, **inputs["loss"]},
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


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("RESULT "):])


def test_two_by_two_moe_losses_equal_jax_sharded_step(tmp_path):
    """The port's (2, 2) MoE steps with 4 replica slots at cf 1.0 against
    ``repro``'s jitted train step on a (2, 2) mesh of forced host devices
    under the same rules, from the same weights, fp32, no weight decay:
    both losses to 1e-5 relative."""
    arch = "qwen2-moe-a2.7b"
    cfg = jconfigs.get_config(arch).reduced()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_init_train_state(jax_build(cfg), jax.random.PRNGKey(3))[0])
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps({
        "arch": arch, "params": params, "tokens": tokens,
        "opt": dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0),
        "loss": {"extra_slots": 4, "capacity_factor": 1.0}}))
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

    rank, world, store, ckpt, dump, steps = sys.argv[1:7]
    dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                            world_size=int(world))
    argv = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", steps, "--batch", "4",
            "--seq", "24", "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2",
            "--model-axis", "2", "--extra-slots", "4"]
    if int(world) == 2:
        argv.append("--resume")
    out = launcher.run(launcher.parse_args(argv))
    mesh = launch_mesh.make_mesh((int(world) // 2, 2), ("data", "model"), "cpu")
    specs = tensor_parallel(get_config("qwen2-moe-a2.7b").reduced(), mesh).specs
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


def test_moe_checkpoint_saved_on_two_by_two_resumes_on_one_by_two(tmp_path):
    """The launcher trains reduced qwen2-moe-a2.7b (4 replica slots) two
    steps on a (2, 2) mesh and saves; the checkpoint is the JAX layout of
    the whole model (the expert leaves put together), equal to the (2, 2)
    ranks' blocks gathered, and ``repro.train.restore_tree`` reads it; a
    (1, 2) run resumes from it and steps.  Its losses are those of the
    launcher at a world of one, to bf16 rounding (tolerance 1e-2: the
    launcher's loss is bf16, and a rounding that flips one top-k choice
    moves a MoE's loss more than a dense model's; measured on the CPU,
    4.6e-3 at the third step, and data parallelism alone, a (2, 1) mesh,
    1.5e-3; in fp32 the split equals one rank to 1e-7, the tests above)."""
    ckpt = tmp_path / "ckpt"
    run = lambda world, steps, dump: _spawn(
        lambda r: ["-c", _LAUNCH, str(r), str(world), str(tmp_path / f"store{world}"),
                   str(ckpt), str(tmp_path / dump), str(steps)], world)
    first = [_result(o) for o in run(4, 2, "saved.npz")]
    step, flat = load_checkpoint(str(ckpt))
    assert step == 2
    saved = np.load(tmp_path / "saved.npz")
    assert sorted(flat) == sorted(saved.files)
    assert flat["params/blocks/experts/w_gate"].shape == (2, 8, 64, 32)
    for key in flat:
        assert np.array_equal(flat[key], saved[key]), key
    cfg = jconfigs.get_config("qwen2-moe-a2.7b").reduced()
    template = dict(zip(("params", "opt"), jax_init_train_state(jax_build(cfg),
                                                                jax.random.PRNGKey(0))))
    restored = jax_restore_tree(template, flat)
    assert all(np.array_equal(np.asarray(a), flat[k]) for k, a in _paths(restored))
    second = [_result(o) for o in run(2, 3, "resumed.npz")]
    assert all(r == first[0] for r in first) and all(r == second[0] for r in second)
    assert second[0]["start"] == 2 and len(second[0]["losses"]) == 1
    from repro_torch.launch import train as launcher
    one = launcher.run(launcher.parse_args(
        ["--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", "3", "--batch", "4", "--seq",
         "24", "--device", "cpu", "--extra-slots", "4"]))
    got = first[0]["losses"] + second[0]["losses"]
    assert np.allclose(got, one["losses"], rtol=1e-2, atol=0), (got, one["losses"])


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    elif tree is not None:
        yield "/".join(prefix), tree
