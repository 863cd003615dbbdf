"""Data, spatial and tensor parallelism over torch.distributed.

Counterpart of promptir_tpu/parallel/: `mesh` (process groups and the rank
launcher), `halo` (the fixed-halo engine), `spatial` (the exact H-sharded
forward) and `tp` (tensor-parallel GDFN and MDTA); `data` makes what
couples a batch's rows (the CAMixer models' draws, batch means and branch
selector) the global batch's under a data group, as the JAX step's one
program over the mesh sees it.
"""
