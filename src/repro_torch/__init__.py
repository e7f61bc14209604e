"""PyTorch/CUDA port of the upcycled-MoE system (``repro``), for one NVIDIA
H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``config``, ``models.*``, ``core.*``, ``kernels.*``,
``serving.engine``, ``launch.serve``) and imports nothing of it, nor JAX.
Parameters are the same nested dicts of tensors, with the same keys, the
stacked ``(periods, ...)`` leading dim and the declared dtypes, so
``params.params_from_numpy`` carries a JAX parameter tree across unchanged.

The slice ported so far is ring-cache serving of dense/MoE GQA models with
the sorted dropless dispatcher. Its TPU kernels (the grouped expert GEMM
and the flash-attention forward) are hand-written CUDA for ``sm_90a`` under
``kernels/csrc``; on a CPU tensor each wrapper runs its plain PyTorch
version instead (``kernels/ref.py``).
"""
