"""PyTorch/CUDA port of the upcycled-MoE system (``repro``), for one NVIDIA
H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``config``, ``models.*``, ``core.*``, ``kernels.*``,
``serving.*``, ``data.pipeline``, ``optim.*``, ``train.*``, ``launch.*``)
and imports nothing of it, nor JAX.
Parameters are the same nested dicts of tensors, with the same keys, the
stacked ``(periods, ...)`` leading dim and the declared dtypes, so
``params.params_from_numpy`` carries a JAX parameter tree across unchanged.

The slices ported so far are ring-cache and paged-KV serving and training
of dense/MoE GQA models with the sorted dropless dispatcher and the padded
capacity-factor one (``allgather``), and int8 expert weights on the sorted
path. Their TPU kernels (the grouped and padded expert GEMMs forward and
backward, the int8 grouped expert GEMM, flash attention forward and
backward, paged-attention decode) are hand-written CUDA for ``sm_90a``
under ``kernels/csrc``; on a CPU tensor each wrapper runs its plain
PyTorch version instead (``kernels/ref.py``).
"""
