"""Data, spatial and tensor parallelism over torch.distributed.

Counterpart of promptir_tpu/parallel/: `mesh` (process groups and the rank
launcher), `halo` (the fixed-halo engine), `spatial` (the exact H-sharded
forward) and `tp` (tensor-parallel GDFN and MDTA).
"""
