"""The port's launch layer (``repro_torch.launch``) against the JAX
package's, on the CPU: the sharding rules for every config on both
production meshes (JAX's from ``jax.eval_shape``, nothing compiled; the
port's from ``init_params`` under ``FakeTensorMode``; each JAX block leaf's
layer dim dropped), the dry run's per-device bytes against the same sum
reckoned from the JAX specs, the meshes, and the train launcher: at a world of
one against ``make_train_step`` bit for bit, a resume against an
uninterrupted run bit for bit, and gloo at a world of two (``torchrun``)
against a world of one."""
import math
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import sharding as jrules
from repro.models import build_model as jax_build
from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch.data import TokenPipeline
from repro_torch.distributed import world
from repro_torch.launch import dryrun, mesh, sharding
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.train.checkpoint import load_checkpoint
from repro_torch.train.optimizer import leaves

_NAMES = sorted(jconfigs.all_configs())
_MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}
_ROOT = Path(__file__).resolve().parents[1]


def _jax_leaves(tree, specs=False) -> dict:
    is_leaf = (lambda x: isinstance(x, P)) if specs else None
    return {jrules._path_str(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _port_leaves(tree, path=()) -> dict:
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_leaves(sub, path + (str(i),)).items()}
    return {"/".join(path): tree}


def _jax_key(key: str) -> tuple[str, bool]:
    parts = key.split("/")
    return ("/".join(["blocks"] + parts[2:]), True) if parts[0] == "blocks" else (key, False)


def _norm(spec, ndim: int, drop: bool) -> tuple:
    """A JAX PartitionSpec as one entry a dim, the layer dim dropped."""
    full = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return full[1:] if drop else full


@pytest.fixture(scope="module")
def shapes():
    """Each config's parameter shapes in both packages (no allocation)."""
    out = {}
    for name in _NAMES:
        jshape = jax.eval_shape(jax_build(jconfigs.get_config(name)).init_params,
                                jax.random.PRNGKey(0))
        with FakeTensorMode():
            params = build_model(tconfigs.get_config(name), device="cpu").init_params(0)
        out[name] = (jshape, params)
    return out


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("name", _NAMES)
def test_param_and_opt_specs_match_jax(shapes, name, multi_pod, fsdp):
    """``param_specs`` and ZeRO-1 ``opt_specs`` (m and v) equal the JAX
    package's for every leaf: each layer's leaf gets the stacked leaf's spec
    without its layer dim (the size thresholds apply to the stacked leaf).
    Every leaf of one tree is a leaf of the other."""
    jshape, params = shapes[name]
    axes = _MESHES[multi_pod]
    model_size, data = axes["model"], axes["data"] if fsdp else 1
    opt_data = axes["data"] * axes.get("pod", 1)
    jspec = jrules.param_specs(jshape, model_size, data)
    jopt = _jax_leaves(jrules.opt_specs(jspec, jshape, opt_data)["m"], specs=True)
    jspec, jleaves = _jax_leaves(jspec, specs=True), _jax_leaves(jshape)
    pspec = sharding.param_specs(params, model_size, data)
    popt = sharding.opt_specs(pspec, params, opt_data)
    assert popt["step"] == () and popt["v"] == popt["m"]
    got, got_opt = _port_leaves(pspec), _port_leaves(popt["m"])
    assert {_jax_key(k)[0] for k in got} == set(jleaves)
    for key, spec in got.items():
        jkey, drop = _jax_key(key)
        nd = len(jleaves[jkey].shape)
        assert spec == _norm(jspec[jkey], nd, drop), key
        assert got_opt[key] == _norm(jopt[jkey], nd, drop), key
        assert len(spec) == len(_port_leaves(params)[key].shape)


def test_opt_specs_refuse_zero1_on_the_layer_dim():
    """A synthetic tree whose stacked leaf [80, 3, 5000] is replicated and
    large enough for ZeRO-1, with the layer count its largest dim divisible
    by 16: the JAX rule shards that layer dim over "data", which a
    per-layer leaf does not have, so the port raises rather than leave the
    moment replicated.  A tree of 81 layers shards the 5000 dim in both."""
    for n_layers, data in ((80, 16), (81, 8)):
        with FakeTensorMode():
            params = {"blocks": [{"x": torch.empty(3, 5000)} for _ in range(n_layers)]}
        jshape = {"blocks": {"x": jax.ShapeDtypeStruct((n_layers, 3, 5000), jnp.float32)}}
        jspec = jrules.param_specs(jshape, 16, 1)
        want = _norm(jrules.opt_specs(jspec, jshape, data)["m"]["blocks"]["x"], 3, True)
        pspec = sharding.param_specs(params, 16, 1)
        assert pspec["blocks"][0]["x"] == _norm(jspec["blocks"]["x"], 3, True) == (None, None)
        if n_layers == 80:
            assert tuple(jrules.opt_specs(jspec, jshape, data)["m"]["blocks"]["x"])[0] == "data"
            with pytest.raises(ValueError, match="on its layer dim"):
                sharding.opt_specs(pspec, params, data)
        else:
            got = sharding.opt_specs(pspec, params, data)["m"]["blocks"]
            assert want == (None, "data") and all(g["x"] == want for g in got)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("name", _NAMES)
def test_batch_and_cache_specs_match_jax(name, multi_pod):
    """``batch_specs`` of every shape cell's inputs and ``cache_specs`` of
    every decode cell's cache (both stacked [L, B, ...] in both packages)
    equal the JAX package's."""
    axes = _MESHES[multi_pod]
    dp = mesh.data_axes(multi_pod)
    jm = jax_build(jconfigs.get_config(name))
    tcfg = tconfigs.get_config(name)
    for shape, spec in tconfigs.SHAPES.items():
        if tconfigs.skip_reason(tcfg, shape):
            continue
        with FakeTensorMode():
            batch = dryrun.input_shapes(tcfg, spec)
            jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32) for k, v in batch.items()}
            got = sharding.batch_specs(batch, dp)
            want = jrules.batch_specs(jbatch, dp)
            assert got == {k: _norm(want[k], len(batch[k].shape), False) for k in batch}, shape
            if spec.kind != "decode":
                continue
            cache = build_model(tcfg, device="cpu").init_cache(spec.global_batch, spec.seq_len)
        jcache = jax.eval_shape(lambda: jm.init_cache(spec.global_batch, spec.seq_len))
        want = _jax_leaves(jrules.cache_specs(jcache, dp, axes["model"]), specs=True)
        jleaves = _jax_leaves(jcache)
        got = _port_leaves(sharding.cache_specs(cache, dp, axes["model"]))
        assert set(got) == set(jleaves), shape
        for key, s in got.items():
            assert tuple(_port_leaves(cache)[key].shape) == tuple(jleaves[key].shape), key
            assert s == _norm(want[key], len(jleaves[key].shape), False), (shape, key)


def _jax_device_bytes(tree, specs, axes) -> int:
    leaves, total = _jax_leaves(tree), 0
    for key, spec in _jax_leaves(specs, specs=True).items():
        shape = leaves[key].shape
        n = 1
        for size, entry in zip(shape, _norm(spec, len(shape), False)):
            names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            n *= -(-size // math.prod(axes[a] for a in names))
        total += n * np.dtype(leaves[key].dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("name", _NAMES)
def test_dryrun_bytes_match_jax_specs(shapes, name, multi_pod):
    """Every shape cell's per-device bytes (params, gradients, AdamW moments
    and step, batch, decode cache) equal the same sum reckoned from the JAX
    package's shapes and specs on that mesh; a skipped cell keeps its
    reason."""
    axes = _MESHES[multi_pod]
    dp = mesh.data_axes(multi_pod)
    model_size, data_size = axes["model"], axes["data"] * axes.get("pod", 1)
    jm = jax_build(jconfigs.get_config(name))
    jshape = shapes[name][0]
    jspec = jrules.param_specs(jshape, model_size, axes["data"])
    want_params = _jax_device_bytes(jshape, jspec, axes)
    for shape, spec in tconfigs.SHAPES.items():
        rec = dryrun.reckon_cell(name, shape, multi_pod)
        reason = jconfigs.skip_reason(jconfigs.get_config(name), shape)
        if reason:
            assert rec["status"] == "skipped" and rec["reason"] == reason
            continue
        assert rec["n_devices"] == math.prod(axes.values()) and rec["flops"] is None
        want = {"params": want_params}
        with FakeTensorMode():
            batch = dryrun.input_shapes(tconfigs.get_config(name), spec)
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), {torch.int32: jnp.int32,
                                                           torch.bfloat16: jnp.bfloat16}[v.dtype])
                  for k, v in batch.items()}
        want["batch"] = _jax_device_bytes(jbatch, jrules.batch_specs(jbatch, dp), axes)
        if spec.kind == "train":
            from repro.train.optimizer import init_opt_state
            jopt = jax.eval_shape(init_opt_state, jshape)
            ospec = jrules.opt_specs(jspec, jshape, data_size)
            want["grads"] = want_params
            want["opt"] = _jax_device_bytes(jopt, {**ospec, "step": P()}, axes)
        if spec.kind == "decode":
            jcache = jax.eval_shape(lambda: jm.init_cache(spec.global_batch, spec.seq_len))
            want["cache"] = _jax_device_bytes(
                jcache, jrules.cache_specs(jcache, dp, model_size), axes)
        assert rec["bytes_per_device"] == want, (shape, rec["bytes_per_device"], want)
        assert rec["total_bytes_per_device"] == sum(want.values())


def test_dryrun_writes_its_cells(tmp_path):
    dryrun.main(["--arch", "rwkv6-3b", "--shape", "train_4k", "--shape", "long_500k",
                 "--both-meshes", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"{m}__rwkv6-3b__{s}.json" for m in ("pod16x16", "pod2x16x16")
                     for s in ("long_500k", "train_4k")]
    assert dryrun.OUT_DIR.parts[-2:] == ("build", "dryrun_torch")


# ---------------------------------------------------------------- meshes
def test_meshes_and_placements():
    """The production meshes refuse a world that is not 256 / 512 ranks,
    naming its size; the host mesh needs an initialized world and is then
    every rank on one axis; ``placements`` maps a spec onto a mesh's dims."""
    with pytest.raises(RuntimeError, match="needs 256 ranks; this world has 1"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks; this world has 1"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        mesh.make_host_mesh(device="cpu")
    assert mesh.data_axes(True) == ("pod", "data") and mesh.data_axes(False) == ("data",)
    with world("cpu") as (group, dev):
        host = mesh.make_host_mesh("data", dev)
        assert host.mesh_dim_names == ("data",) and tuple(host.shape) == (group.size(),) == (1,)
        assert sharding.placements(host, ("data", None)) == (Shard(0),)
        assert sharding.placements(host, (None, "model")) == (Replicate(),)
    assert not torch.distributed.is_initialized()
    prod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.placements(prod, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements(prod, ()) == (Replicate(),) * 3


def test_launcher_refuses_prod_meshes_below_256_ranks():
    for name in ("prod", "prod-multipod"):
        with pytest.raises(RuntimeError, match="this world has 1"):
            launcher.run(launcher.parse_args(["--mesh", name, "--device", "cpu", "--reduced"]))
    assert not torch.distributed.is_initialized()


# -------------------------------------------------------------- launcher
def _args(arch, steps, **kw):
    argv = ["--arch", arch, "--reduced", "--steps", str(steps), "--batch", "4", "--seq", "24",
            "--device", "cpu"]
    for key, value in kw.items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if value is True else [flag, str(value)]
    return launcher.parse_args(argv)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-3b", "qwen2-moe-a2.7b"])
def test_launcher_at_world_one_equals_train_step(arch):
    """The launcher at a world of one (a gloo group of this process; the
    gradient "mean" an all_reduce over one rank) equals ``make_train_step``
    driven by hand on the same pipeline batches: every loss and every
    parameter and moment after three steps, bit for bit."""
    out = launcher.run(_args(arch, 3))
    assert not torch.distributed.is_initialized()
    cfg = tconfigs.get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    opt = ttrain.OptConfig(total_steps=3, warmup_steps=5)
    step = ttrain.make_train_step(model, opt,
                                  {"extra_slots": 8} if cfg.family == "moe" else {})
    params, state = ttrain.init_train_state(model, 0)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=24, seed=0)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, {"tokens": torch.from_numpy(pipe.next_batch())})
        losses.append(float(m["loss"]))
    assert out["losses"] == losses and out["start"] == 0
    for got, want in [(out["params"], params), (out["opt"]["m"], state["m"]),
                      (out["opt"]["v"], state["v"])]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


def test_launcher_resume_is_bit_for_bit(tmp_path):
    """Four steps straight through against two steps, a checkpoint, and a
    ``--resume`` run of two more: the step-4 checkpoints (params, m, v,
    step) are equal bit for bit, and so are the resumed run's losses."""
    whole = launcher.run(_args("rwkv6-3b", 4, ckpt_dir=tmp_path / "a", ckpt_every=2))
    launcher.run(_args("rwkv6-3b", 2, ckpt_dir=tmp_path / "b", ckpt_every=2))
    resumed = launcher.run(_args("rwkv6-3b", 4, ckpt_dir=tmp_path / "b", ckpt_every=2,
                               resume=True))
    assert resumed["start"] == 2 and resumed["losses"] == whole["losses"][2:]
    (sa, a), (sb, b) = load_checkpoint(str(tmp_path / "a")), load_checkpoint(str(tmp_path / "b"))
    assert sa == sb == 4 and sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _torchrun(argv, nproc):
    """``python -m torch.distributed.run --standalone`` over ``nproc`` CPU
    processes (gloo), the environment stripped as the shuffle's tests strip
    it; returns the stdout of every rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "repro_torch.launch.train", *argv]
    env = {"PYTHONPATH": str(_ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=_ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _world_two_against_one(tmp_path, arch):
    """(the logged losses at worlds one and two, the distance of world two's
    parameters from world one's after three steps, how far world one's
    moved from the initial ones)."""
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "4", "--seq", "24",
            "--device", "cpu", "--ckpt-every", "3"]
    logs = [_torchrun(argv + ["--ckpt-dir", str(tmp_path / f"w{n}")], n) for n in (1, 2)]
    losses = [[float(x) for x in re.findall(r"loss=([0-9.e+-]+)", log)] for log in logs]
    assert len(losses[0]) == len(losses[1]) == 2  # steps 0 and 2, logged by rank 0
    (_, one), (_, two) = (load_checkpoint(str(tmp_path / f"w{n}")) for n in (1, 2))
    p0 = _init_flat(arch)
    keys = [k for k in one if k.startswith("params/")]
    moved = math.sqrt(sum(float(np.sum((one[k] - p0[k]) ** 2)) for k in keys))
    diff = math.sqrt(sum(float(np.sum((two[k] - one[k]) ** 2)) for k in keys))
    return losses, diff, moved


def test_launcher_gloo_world_two_equals_world_one(tmp_path):
    """``torchrun`` with two gloo ranks, each taking half of the global
    batch and averaging the gradients, against one process with the whole
    batch.  The launcher computes in bf16 (the loss's default dtype, as the
    JAX launcher's), so each rank's weight gradients are bf16 products over
    half the rows, rounded to bf16 before the mean (measured about 3e-3 of
    each leaf's largest entry off the whole batch's): the logged losses to
    1e-4 relative, the parameters after three steps to 2e-2 of the update
    (measured 1e-2; AdamW divides each entry by its own RMS, so a small
    gradient's rounding moves its entry by up to lr)."""
    losses, diff, moved = _world_two_against_one(tmp_path, "olmo-1b")
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert 0 < diff <= 2e-2 * moved, (diff, moved)


def test_launcher_gloo_world_two_equals_world_one_moe(tmp_path):
    """The same for qwen2-moe-a2.7b (8 replica slots, the launcher's): the
    replica plan and the aux loss are the global batch's on both ranks
    (``moe_ffn`` sums its expert counts and router probabilities over the
    launcher's group), so step 0's loss, before any update, equals world
    one's to 1e-5 (measured 7e-8; each rank's own plan and aux were 7.6e-3
    off).  After that the bf16 rounding of the half-batch gradients moves
    discrete choices (top-k routes, capacity drops) that olmo-1b does not
    have: step 2's loss to 2e-3 (measured 6.6e-4; 5.6e-3 without the
    group) and the parameters to 0.25 of the update (measured 0.11; 0.59
    without the group)."""
    losses, diff, moved = _world_two_against_one(tmp_path, "qwen2-moe-a2.7b")
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1][1], losses[0][1], rtol=2e-3)
    assert 0 < diff <= 0.25 * moved, (diff, moved)


def _init_flat(arch: str) -> dict:
    from repro_torch.models.convert import train_state_to_jax_layout
    from repro_torch.train.checkpoint import _flatten_with_paths

    model = build_model(tconfigs.get_config(arch).reduced(), device="cpu")
    params, state = ttrain.init_train_state(model, 0)
    return _flatten_with_paths(train_state_to_jax_layout({"params": params, "opt": state}))
