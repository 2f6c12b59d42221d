"""Launch layer: production meshes, sharding rules, dry run, train launcher
(the port of ``repro.launch``).

  * ``mesh`` — ``make_mesh`` (any grid of the default group's ranks, in
    ``jax.make_mesh``'s order, with a process group a axis and one for the
    data axes), ``make_production_mesh`` ((16, 16) or (2, 16, 16) over 256
    or 512 ranks), ``make_host_mesh`` (every rank on one axis),
    ``data_axes``;
  * ``sharding`` — the JAX package's rules (params, ZeRO-1 moments, batches,
    caches), each layer's leaf given the stacked leaf's spec with its layer
    dim dropped; ``placements``; ``shard_tree`` / ``gather_tree`` (this
    rank's blocks of a tree, and the whole leaves back);
  * ``train`` — the launcher, ``python -m repro_torch.launch.train``: data
    parallelism over the data axes and, for the dense, vlm and audio
    families, tensor parallelism over "model" (``models.tensor_parallel``)
    on any (data, model) mesh: ``--mesh prod`` / ``prod-multipod`` at 256 /
    512 ranks, ``--model-axis`` on a host mesh;
  * ``dryrun`` — per-device bytes of every (arch x shape) cell on both
    production meshes, reckoned from shapes under ``FakeTensorMode``.

``repro.launch.hlo_analysis`` has no counterpart: it reads the compiled HLO
of an XLA program (loop trip counts, dot FLOPs, collective bytes), and the
port compiles no such program: its layers place their collectives by hand.
So the dry run reckons bytes from shapes and leaves FLOPs and collectives
out, saying why (``dryrun``'s docstring, ``dryrun.FLOPS_NOTE``).
"""
from .mesh import data_axes, make_host_mesh, make_production_mesh

__all__ = ["data_axes", "make_host_mesh", "make_production_mesh"]
