"""few_shot_seg_cwt_tpu_torch: the PyTorch/CUDA port of few_shot_seg_cwt_tpu.

The port runs the paper's stage-2 CWT episode (1-shot, ResNet-50 dilated
PSPNet, 200-step closed-form inner loop, classifier weight transformer) on an
NVIDIA Hopper GPU. It mirrors the JAX package's subpackage layout and keeps
its public layouts (NHWC episodes and features) so the two can be compared
function by function, but imports nothing of it: configuration, synthetic
data and resize matrices are the port's own copies.

The TPU inner-loop kernel (``few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py``)
is a hand-written CUDA C++ kernel here (``csrc/inner_loop.cu``, wrapped by
``ops/cuda_inner_loop.py``). Convolutions and large matrix products go to
plain torch ops. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
