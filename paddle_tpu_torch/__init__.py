"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package ``paddle_tpu`` is the reference; this package imports
``torch`` only, never ``jax`` and nothing of ``paddle_tpu``. Every TPU
(Pallas) kernel on a ported path has a hand-written Hopper kernel under
``csrc/``, built by ``nvcc`` at first CUDA use (``ops/build.py``) — never
at import, so the CPU tests import everything without a toolkit.

Slice 1 is the paged Llama serving path: ``serving.Server`` over
``serving.PagedEngine`` over ``models.LlamaForCausalLM``, with the
RMSNorm and paged-attention decode kernels. Slice 2 is the training
step: ``jit.TrainStep`` with ``optimizer.AdamW`` after ``amp.decorate``
over ``LlamaForCausalLM(ids, labels)``, with the flash attention
(forward, dq, dkv), RoPE and AdamW kernels and RMSNorm's gradient.
Slice 3 serves over the int8 KV arena (the int8 paged-decode kernel)
with threefry sampling. Slice 4 is the ERNIE-MoE training step:
``models.ErnieMoEForCausalLM`` under ``amp.auto_cast`` with AdamW over
bf16 moments, with the MoE row-gather and fused softmax cross-entropy
kernels. Slice 10 is the dense serving engine
(``serving.ContinuousBatchingEngine``) and ``LlamaForCausalLM.generate``,
each as CUDA graphs, with RoPE's serving route. Slice 11 is bench.py's
headline training configuration: the stacked trunk
(``LlamaConfig(scan_layers=True)``) with full or selective per-layer
recompute, pure bf16 with bf16 AdamW moments, LR schedulers
(``optimizer.lr``) and gradient clipping (``grad_clip=``,
``nn.utils``)."""
from .device import resolve_device

__all__ = ["resolve_device"]
