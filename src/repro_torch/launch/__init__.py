"""Launch layer: production meshes, sharding rules, dry run, train launcher
(the port of ``repro.launch``).

  * ``mesh`` — ``make_production_mesh`` ((16, 16) or (2, 16, 16) over 256 or
    512 ranks), ``make_host_mesh`` (every rank on one axis), ``data_axes``:
    ``DeviceMesh`` objects over the default group that
    ``repro_torch.distributed`` picks;
  * ``sharding`` — the JAX package's rules (params, ZeRO-1 moments, batches,
    caches), each layer's leaf given the stacked leaf's spec with its layer
    dim dropped; ``placements`` for a ``DeviceMesh``;
  * ``train`` — the launcher, ``python -m repro_torch.launch.train``: data
    parallelism over every rank (``--mesh host``); the production meshes are
    built and refused (tensor parallelism through the layers is not ported);
  * ``dryrun`` — per-device bytes of every (arch x shape) cell on both
    production meshes, reckoned from shapes under ``FakeTensorMode``.

``repro.launch.hlo_analysis`` has no counterpart: it reads the compiled HLO
of an XLA program (loop trip counts, dot FLOPs, collective bytes), and the
port compiles no such program; nor does it build a partitioned one (tensor
parallelism through the layers is ROADMAP item 22).  So the dry run reckons
bytes from shapes and leaves FLOPs and collectives out, saying why
(``dryrun``'s docstring, ``dryrun.FLOPS_NOTE``).
"""
from .mesh import data_axes, make_host_mesh, make_production_mesh

__all__ = ["data_axes", "make_host_mesh", "make_production_mesh"]
