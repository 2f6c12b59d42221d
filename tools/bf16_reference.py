"""The training path's first gradients against float64 and against the JAX
package's own, depth by depth, on the CPU: what bf16 and fp32 rounding move,
and whether the port moves more than the reference does.

  PYTHONPATH=src python tools/bf16_reference.py --arch rwkv6-3b --depths 2,4,8 \\
      [--seeds 0] [--batch 8 --seq 128] [--out build/bf16_reference.json]
  PYTHONPATH=src python tools/bf16_reference.py --arch rwkv6-3b --reduced --seeds 0,1,2,3 \\
      --batch 4 --seq 64
  PYTHONPATH=src python tools/bf16_reference.py --arch rwkv6-3b --depths 16 \\
      --ops none,group_norm,wkv,decay,layer_norm,relu2

Each depth is the configuration at its full width cut to that many layers
(``dataclasses.replace(cfg, n_layers=L)``; ``--reduced``: the reduced
configuration at its own depth), with the JAX package's weights of
``PRNGKey(seed)`` (carried into the port by ``params_from_jax``) and the
launcher's first batch, ``TokenPipeline(vocab, batch, seq, seed)`` ([batch,
seq + 1] tokens); a second batch feeds the loss after one update.  Of one
``loss_fn`` with remat on (moe: ``extra_slots=8``, the launcher's), five
gradients:

* ``jax_bf16``, ``jax_fp32``: ``jax.grad`` of the JAX package's loss;
* ``port_bf16``, ``port_fp32``: the port's, on the CPU (its kernels' plain
  versions);
* ``f64``: the port's in float64, in a process of its own in which every
  fp32 of the model's code reads as float64 (``tools/recurrent_precision.py``'s
  ``f64_worker`` mechanism: ``torch.float32`` and ``Tensor.float`` rebound);
  the leaves stay fp32 there and are cast to float64 at every use, so that
  process holds one fp32 copy of the weights and one of the gradients.

Gradients are fp32 on the host, at most two trees at once besides the
weights; the first weights wait on disk for the updates.  Printed, and
written to ``--out`` as JSON: each gradient's global norm and its distance
from float64, from its own package's fp32 and (the port's bf16) from the
JAX package's bf16, all relative to the named reference's norm, the same
for each leaf kind (``tm/u``, ``cm/Wv``, ... over every block), the share
of entries whose sign differs from float64, and the second batch's bf16
loss after AdamW's first update from each gradient (the optimizer's own
arithmetic, ``launcher_split._first_update``, on the schedule of the
launcher's ``--steps 5``).  Last, ``d*`` over the depths run: the first depth at which
the port's fp32 gradient lies more than 1e-2 of the float64 norm from
float64.

``--ops`` (rwkv6-3b only) instead runs the port's fp32 gradient through a
copy of its RWKV-6 forward made here (``src/repro_torch/`` has no switch)
with one operation at a time in float64 and the rest in fp32 (``none``:
every operation fp32, which must give the port's fp32 gradient bit for
bit; ``group_norm``: the per-head group norm; ``wkv``: the recurrence with
its bonus ``u``; ``decay``: ``exp(-exp(.))`` and its LoRA; ``layer_norm``:
every layer norm; ``relu2``: the channel mix's ``relu(x Wk)^2 Wv``;
``proj_in``: the time mix's r, k, v and g projections; ``proj_out``: its
output projection and the channel mix's r; ``stream``: the residual stream, its token
shift, lerps and adds; ``head``: the readout's cross entropy; a
``+``-joined name runs several, ``all`` every one, ``all-X`` every one but
X), each against float64.

Needs both packages (JAX on the CPU); no module of ``repro_torch`` imports
this file.  Measures, asserts nothing but the ``none`` copy's bits.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from launcher_split import _first_update, _kind  # noqa: E402  (the sibling tool's helpers)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import build_model, convert, params_from_jax  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.models.layers import chunked_cross_entropy, embed, remat  # noqa: E402
from repro_torch.train import OptConfig  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

D_STAR_TOL = 1e-2
STEPS = 5  # the launcher runs' --steps, which set AdamW's schedule
GRADS = ("f64", "jax_bf16", "jax_fp32", "port_bf16", "port_fp32")
OPS = ("group_norm", "wkv", "decay", "layer_norm", "relu2", "proj_in", "proj_out", "stream",
       "head")


def _say(*a) -> None:
    print(*a, flush=True)


def _configs(name: str, depth: int | None, reduced: bool):
    from repro import configs as jconfigs

    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    if reduced:
        j, t = j.reduced(), t.reduced()
    if depth:
        j, t = dataclasses.replace(j, n_layers=depth), dataclasses.replace(t, n_layers=depth)
    return j, t


def _loss_kwargs(cfg) -> dict:
    return {"extra_slots": 8} if cfg.family == "moe" else {}


def _batches(cfg, batch: int, seq: int, seed: int) -> list[torch.Tensor]:
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    return [torch.from_numpy(pipe.next_batch()) for _ in range(2)]


def _jax_params(jcfg, seed: int):
    import jax

    from repro.models import build_model as jax_build

    jm = jax_build(jcfg)
    return jm, jm.init_params(jax.random.PRNGKey(seed))


def _port_order(tcfg, flat: dict, names: list[str]) -> list[np.ndarray]:
    """A JAX-layout flat dict as the port's leaves (``names``' order)."""
    got = convert.flat_from_jax_layout(flat)
    return [np.asarray(got[n.strip("/")], dtype=np.float32) for n in names]


def _jax_flat(tree) -> dict:
    import jax

    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _names(tcfg) -> list[str]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tensor_parallel import _paths

    with FakeTensorMode():
        return _paths(build_model(tcfg, "cpu").init_params(0))


# ------------------------------------------------------------ the float64 run
def f64_worker(name: str, depth: int, seed: int, reduced: bool, batch: int, seq: int,
               out: str) -> None:
    """The port's gradient in float64 at the JAX weights: fp32 leaves, every
    fp32 of the model's code read as float64 for this process."""
    import repro_torch.kernels.wkv6 as k7

    jcfg, tcfg = _configs(name, depth, reduced)
    jm, jp = _jax_params(jcfg, seed)
    import jax

    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    del jm, jp
    tokens = _batches(tcfg, batch, seq, seed)[0]
    model = build_model(tcfg, "cpu")
    torch.Tensor.float = torch.Tensor.double
    torch.float32 = torch.float64
    k7.INPUT_DTYPES = k7.INPUT_DTYPES + (torch.float64,)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.loss_fn(params, {"tokens": tokens}, dtype=torch.float64, remat=True,
                         **_loss_kwargs(tcfg))
    loss.backward()
    torch.save({"loss": float(loss.detach()), "grads": [p.grad for p in leaves(params)]}, out)


def _f64(name, depth, seed, reduced, batch, seq, tmp) -> tuple[float, list[torch.Tensor]]:
    path = os.path.join(tmp, "f64.pt")
    cmd = [sys.executable, __file__, "--f64-worker", name, str(depth or 0), str(seed),
           str(int(reduced)), str(batch), str(seq), path]
    subprocess.run(cmd, check=True, env=dict(os.environ))
    got = torch.load(path, mmap=True)
    return got["loss"], got["grads"]


# ---------------------------------------------------- RWKV-6 with ops in f64
def _hi(ops, name: str) -> torch.dtype:
    return torch.float64 if name in ops else torch.float32


def _ln(p, x, hi):
    """``layers.layer_norm`` with its arithmetic in ``hi``, back in x's dtype."""
    xf = x.to(hi)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * p["scale"].to(hi) + p["bias"].to(hi)).to(x.dtype)


def _time_mix(tm, x, cfg, ops):
    from repro_torch.kernels.wkv6 import wkv6

    b, l, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    dx = trw._shift(x) - x

    def lerp(mu):  # in the stream's dtype
        return x + dx * tm[mu].to(x.dtype)

    pr, po = _hi(ops, "proj_in"), _hi(ops, "proj_out")

    def proj(mu, w):
        return lerp(mu).to(pr) @ tm[w].to(pr)

    r = proj("mu_r", "Wr").reshape(b, l, h, hd)
    k = proj("mu_k", "Wk").reshape(b, l, h, hd)
    v = proj("mu_v", "Wv").reshape(b, l, h, hd)
    g = torch.nn.functional.silu(proj("mu_g", "Wg"))
    hi = _hi(ops, "decay")
    w = torch.exp(-torch.exp(tm["w0"].to(hi) + torch.tanh(lerp("mu_w").to(hi) @ tm["wA"].to(hi))
                             @ tm["wB"].to(hi))).reshape(b, l, h, hd)
    hi = _hi(ops, "wkv")
    y, _ = wkv6(r.to(hi), k.to(hi), v.to(hi), w.to(hi), tm["u"].to(hi))
    hi = _hi(ops, "group_norm")
    yf = y.to(hi)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + 1e-5)
    y = yn.reshape(b, l, d) * tm["ln_x"]["scale"].to(hi) + tm["ln_x"]["bias"].to(hi)
    return ((y.to(po) * g.to(po)) @ tm["Wo"].to(po)).to(x.dtype)


def _channel_mix(cm, x, ops):
    dx = trw._shift(x) - x

    def lerp(mu):
        return x + dx * cm[mu].to(x.dtype)

    hi, pr = _hi(ops, "relu2"), _hi(ops, "proj_out")
    k = torch.square(torch.relu(lerp("mu_k").to(hi) @ cm["Wk"].to(hi)))
    v = k @ cm["Wv"].to(hi)
    r = torch.sigmoid(lerp("mu_r").to(pr) @ cm["Wr"].to(pr))
    return r.to(x.dtype) * v.to(x.dtype)


def _block(cfg, ops, blk, x):
    hi = _hi(ops, "layer_norm")
    x = x + _time_mix(blk["tm"], _ln(blk["ln1"], x, hi), cfg, ops)
    return x + _channel_mix(blk["cm"], _ln(blk["ln2"], x, hi), ops)


def _cross_entropy(x, table, labels, hi):
    """``layers.chunked_cross_entropy`` (one chunk) with its arithmetic in
    ``hi``."""
    logits = x.to(hi) @ table.to(hi).T
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum() / labels.numel()


def rwkv6_loss_ops(cfg, params, tokens, ops: frozenset) -> torch.Tensor:
    """The port's fp32 ``rwkv6.loss_fn`` (remat on, no split) with ``ops``
    in float64 (``OPS``; ``stream``: the embedded stream, its token shift,
    lerps and residual adds; ``head``: the readout's cross entropy)."""
    x = embed(params["embed"], tokens, torch.float32).to(_hi(ops, "stream"))
    hi = _hi(ops, "layer_norm")
    x = _ln(params["ln0"], x, hi)
    for blk in params["blocks"]:
        x = remat(partial(_block, cfg, ops), blk, x)
    x = _ln(params["final_norm"], x, hi)
    if "head" in ops:
        return _cross_entropy(x[:, :-1, :], params["lm_head"]["w"].T, tokens[:, 1:],
                              torch.float64)
    return chunked_cross_entropy(x[:, :-1, :].float(), params["lm_head"]["w"].T, tokens[:, 1:])


def _ops_of(spec: str) -> frozenset:
    """``none``, ``all``, ``all-X`` (every op but X) or ``a+b+...``."""
    if spec == "none":
        return frozenset()
    if spec.startswith("all"):
        return frozenset(OPS) - frozenset(spec[4:].split("+") if spec != "all" else ())
    return frozenset(spec.split("+"))


# ------------------------------------------------------------- the tallies
def _kinds(names: list[str]) -> list[str]:
    return [_kind(n) for n in names]


_CHUNK = 1 << 24  # entries a float64 pass holds at once


def _flat(a) -> torch.Tensor:
    return (torch.from_numpy(a) if isinstance(a, np.ndarray) else a.detach()).reshape(-1)


def _sums(a, b=None) -> tuple[float, float]:
    """The sum of squares of ``a`` (or of ``a - b``) in float64 and the count
    of entries whose signs differ, a chunk at a time."""
    a = _flat(a)
    b = None if b is None else _flat(b)
    sq = flips = 0.0
    for i in range(0, a.numel(), _CHUNK):
        x = a[i:i + _CHUNK].double()
        if b is None:
            sq += float(torch.sum(x * x))
            continue
        y = b[i:i + _CHUNK].double()
        sq += float(torch.sum(torch.square(x - y)))
        flips += float(torch.sum((x * y) < 0))
    return sq, flips


def _norms(g, kinds) -> dict:
    out: dict = {}
    for a, k in zip(g, kinds):
        s, _ = _sums(a)
        out[k] = out.get(k, 0.0) + s
        out["all"] = out.get("all", 0.0) + s
    return {k: math.sqrt(v) for k, v in out.items()}


def _dist(a_list, b_list, kinds) -> tuple[dict, dict]:
    """The distance of two gradients, globally and by leaf kind, and the
    share of entries whose signs differ (where both are non-zero)."""
    sq, flips, n = {}, {}, {}
    for a, b, k in zip(a_list, b_list, kinds):
        s, f = _sums(a, b)
        for key in (k, "all"):
            sq[key] = sq.get(key, 0.0) + s
            flips[key] = flips.get(key, 0.0) + f
            n[key] = n.get(key, 0) + _flat(a).numel()
    return ({k: math.sqrt(v) for k, v in sq.items()}, {k: flips[k] / n[k] for k in flips})


class Loss2:
    """The second batch's bf16 loss after AdamW's first update from a
    gradient, on the port's model at the first weights (kept on disk)."""

    def __init__(self, tcfg, p0_path: str, b2: torch.Tensor):
        self.model = build_model(tcfg, "cpu")
        self.p0 = torch.load(p0_path, mmap=True)
        self.params = self.model.init_params(0)
        self.b2, self.kw = b2, _loss_kwargs(tcfg)
        self.opt = OptConfig(total_steps=STEPS, warmup_steps=max(5, STEPS // 20))
        self.reset()

    def reset(self) -> None:
        with torch.no_grad():
            for p, q in zip(leaves(self.params), self.p0):
                p.copy_(q)

    def __call__(self, g) -> float:
        norm = math.sqrt(sum(_sums(a)[0] for a in g))
        clip = torch.clamp(torch.tensor(self.opt.grad_clip / (norm + 1e-9)), max=1.0)
        stepf = torch.tensor(1.0)
        with torch.no_grad():
            for p, q, a in zip(leaves(self.params), self.p0, g):
                a = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                p.copy_(q - _first_update(q, a, clip, self.opt, stepf))
            out = float(self.model.loss_fn(self.params, {"tokens": self.b2}, **self.kw))
        self.reset()
        return out


def _port_grads(model, params, tokens, dtype, kw) -> tuple[float, list[torch.Tensor]]:
    for p in leaves(params):
        p.grad = None
    loss = model.loss_fn(params, {"tokens": tokens}, dtype=dtype, remat=True, **kw)
    loss.backward()
    out = [p.grad for p in leaves(params)]
    for p in leaves(params):
        p.grad = None
    return float(loss.detach()), out


def run_one(name: str, depth: int | None, seed: int, reduced: bool, batch: int, seq: int,
            tmp: str) -> dict:
    """The five gradients of one configuration, depth and seed, compared."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    jcfg, tcfg = _configs(name, depth, reduced)
    names = _names(tcfg)
    kinds = _kinds(names)
    b1, b2 = _batches(tcfg, batch, seq, seed)
    kw = _loss_kwargs(tcfg)
    res: dict = {"arch": name, "depth": tcfg.n_layers, "seed": seed, "reduced": reduced,
                 "tokens": list(b1.shape), "loss": {}, "norm": {}, "off": {}, "sign_off_f64": {},
                 "loss2": {}}
    res["loss"]["f64"], f64 = _f64(name, depth, seed, reduced, batch, seq, tmp)
    res["norm"]["f64"] = _norms(f64, kinds)

    def against(key, g, ref_key, ref):
        d, flips = _dist(g, ref, kinds)
        res["off"][f"{key}~{ref_key}"] = {k: d[k] / max(res["norm"][ref_key][k], 1e-30)
                                          for k in d}
        if ref_key == "f64":
            res["sign_off_f64"][key] = flips

    jm, jp = _jax_params(jcfg, seed)
    p0_path = os.path.join(tmp, "p0.pt")
    torch.save([torch.from_numpy(a) for a in _port_order(tcfg, _jax_flat(jp), names)], p0_path)
    jtok = jnp.asarray(b1.numpy())
    held = {}
    for key, dt in (("jax_bf16", jnp.bfloat16), ("jax_fp32", jnp.float32)):
        loss, g = jax.jit(jax.value_and_grad(lambda p, dt=dt: jm.loss_fn(
            p, {"tokens": jtok}, dtype=dt, remat=True, **kw)))(jp)
        res["loss"][key] = float(loss)
        held[key] = _port_order(tcfg, _jax_flat(g), names)
        del g
        res["norm"][key] = _norms(held[key], kinds)
        against(key, held[key], "f64", f64)
    against("jax_bf16", held["jax_bf16"], "jax_fp32", held["jax_fp32"])
    del jp, jm
    jax.clear_caches()
    loss2 = Loss2(tcfg, p0_path, b2)
    res["loss2"]["jax_fp32"] = loss2(held.pop("jax_fp32"))
    res["loss2"]["jax_bf16"] = loss2(held["jax_bf16"])
    res["loss2"]["f64"] = loss2(f64)
    model, params = loss2.model, loss2.params
    for p in leaves(params):
        p.requires_grad_(True)
    for key, dt in (("port_bf16", torch.bfloat16), ("port_fp32", torch.float32)):
        res["loss"][key], g = _port_grads(model, params, b1, dt, kw)
        res["norm"][key] = _norms(g, kinds)
        against(key, g, "f64", f64)
        if key == "port_bf16":
            against(key, g, "jax_bf16", held.pop("jax_bf16"))
            held[key] = g
        else:
            against("port_bf16", held.pop("port_bf16"), key, g)
        res["loss2"][key] = loss2(g)
    res["seconds"] = time.perf_counter() - t0
    _report(res)
    return res


def run_ops(name: str, depth: int | None, seed: int, reduced: bool, batch: int, seq: int,
            ops_list: list[str], tmp: str) -> dict:
    """Part of item 34: the port's fp32 gradient with the operations of each
    spec of ``ops_list`` (``_ops_of``) in float64, against float64."""
    import jax

    import repro_torch.kernels.wkv6 as k7

    jcfg, tcfg = _configs(name, depth, reduced)
    assert tcfg.family == "ssm", "--ops copies RWKV-6's forward"
    k7.INPUT_DTYPES = k7.INPUT_DTYPES + (torch.float64,)  # the recurrence in float64
    names = _names(tcfg)
    kinds = _kinds(names)
    b1, _ = _batches(tcfg, batch, seq, seed)
    res: dict = {"arch": name, "depth": tcfg.n_layers, "seed": seed, "tokens": list(b1.shape),
                 "ops": {}}
    loss64, f64 = _f64(name, depth, seed, reduced, batch, seq, tmp)
    n64 = _norms(f64, kinds)
    res["f64"] = {"loss": loss64, "norm": n64["all"]}
    jm, jp = _jax_params(jcfg, seed)
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    del jm, jp
    for p in leaves(params):
        p.requires_grad_(True)
    model = build_model(tcfg, "cpu")
    want = _port_grads(model, params, b1, torch.float32, {}) if "none" in ops_list else None
    for ops in ops_list:
        t = time.perf_counter()
        chosen = _ops_of(ops)
        assert chosen <= set(OPS), ops
        loss = rwkv6_loss_ops(tcfg, params, b1, chosen)
        loss.backward()
        g = [p.grad for p in leaves(params)]
        for p in leaves(params):
            p.grad = None
        if not chosen:  # the copy is the port's fp32 path, bit for bit but for the
            # table's scatter-add, whose order the CPU does not fix between two runs
            assert float(loss.detach()) == want[0], (float(loss.detach()), want[0])
            for leaf, a, b in zip(names, g, want[1]):
                assert (torch.equal(a, b) if leaf != "/embed/table" else
                        float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())), leaf
            want = None
        d, flips = _dist(g, f64, kinds)
        worst = sorted(((d[k] / max(n64[k], 1e-30), k) for k in d if k != "all"),
                       reverse=True)[:4]
        r = res["ops"][ops] = {"loss": float(loss), "off_f64": d["all"] / n64["all"],
                               "sign_off_f64": flips["all"], "worst_kinds": worst,
                               "seconds": time.perf_counter() - t}
        _say(f"[ops] {name} depth {tcfg.n_layers} seed {seed}: fp32 with {ops} in float64: "
             f"loss {r['loss']!r} (float64 {loss64!r}), gradient off float64 "
             f"{r['off_f64']:.6g} of its norm {n64['all']:.6g} (signs differ "
             f"{r['sign_off_f64']:.4g}); worst kinds {[(round(x, 6), k) for x, k in worst]}; "
             f"{r['seconds']:.1f} s")
    return res


def _report(res: dict) -> None:
    tag = (f"{res['arch']}{' reduced' if res['reduced'] else ''} depth {res['depth']} seed "
           f"{res['seed']}, tokens {res['tokens']}")
    n, off = res["norm"], res["off"]
    _say(f"[ref] {tag}: losses {res['loss']}; global norms "
         f"{ {k: round(v['all'], 6) for k, v in n.items()} }; {res['seconds']:.1f} s")
    _say(f"[ref] {tag}: off float64 (of its norm): "
         + ", ".join(f"{k} {off[f'{k}~f64']['all']:.6g}" for k in GRADS[1:])
         + f"; jax_bf16 off jax_fp32 {off['jax_bf16~jax_fp32']['all']:.6g}, port_bf16 off "
           f"port_fp32 {off['port_bf16~port_fp32']['all']:.6g}, port_bf16 off jax_bf16 "
           f"{off['port_bf16~jax_bf16']['all']:.6g}")
    _say(f"[ref] {tag}: signs that differ from float64: "
         + ", ".join(f"{k} {v['all']:.4g}" for k, v in res["sign_off_f64"].items()))
    _say(f"[ref] {tag}: the second batch's bf16 loss after AdamW's first update from each "
         f"gradient: {res['loss2']}")
    for k in sorted(n["f64"]):
        if k == "all":
            continue
        _say(f"[ref]   {k}: norm f64 {n['f64'][k]:.4g}; off f64 "
             + ", ".join(f"{g} {off[f'{g}~f64'][k]:.4g}" for g in GRADS[1:])
             + f"; bf16 off own fp32 jax {off['jax_bf16~jax_fp32'][k]:.4g} port "
               f"{off['port_bf16~port_fp32'][k]:.4g}")


def d_star(results: list[dict]) -> dict:
    """Per configuration, the first depth (over seed 0 or the lowest seed
    run) at which the port's fp32 gradient lies more than ``D_STAR_TOL`` of
    the float64 norm from it; None where no depth run does."""
    out: dict = {}
    for r in sorted(results, key=lambda r: (r["arch"], r["depth"])):
        key = r["arch"] + (" reduced" if r["reduced"] else "")
        out.setdefault(key, None)
        if out[key] is None and r["off"]["port_fp32~f64"]["all"] > D_STAR_TOL:
            out[key] = r["depth"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/bf16_reference.py")
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--depths", default="", help="comma-separated; empty: the config's own")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ops", default="", help="rwkv6-3b: comma-separated op sets in float64")
    ap.add_argument("--out", default="build/bf16_reference.json")
    ap.add_argument("--f64-worker", nargs=7, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.f64_worker:
        name, depth, seed, reduced, batch, seq, out = args.f64_worker
        f64_worker(name, int(depth) or None, int(seed), bool(int(reduced)), int(batch),
                   int(seq), out)
        return 0
    depths = [int(d) for d in args.depths.split(",") if d] or [None]
    seeds = [int(s) for s in args.seeds.split(",")]
    _say(f"[ref] CPU, torch {torch.__version__}, {torch.get_num_threads()} threads")
    results = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for depth in depths:
        for seed in seeds:
            tmp = tempfile.mkdtemp(prefix="bf16ref_")
            try:
                if args.ops:
                    results.append(run_ops(args.arch, depth, seed, args.reduced, args.batch,
                                           args.seq, args.ops.split(","), tmp))
                else:
                    results.append(run_one(args.arch, depth, seed, args.reduced, args.batch,
                                           args.seq, tmp))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            with open(args.out, "w") as f:
                json.dump({"results": results}, f)
    out = {"results": results}
    if not args.ops:
        out["d_star"] = d_star(results)
        _say(f"[ref] d* (the first depth run where the port's fp32 lies more than "
             f"{D_STAR_TOL} of the float64 norm from float64): {out['d_star']}")
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
