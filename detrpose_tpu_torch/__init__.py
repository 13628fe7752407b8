"""detrpose-tpu-torch: the PyTorch / CUDA port of detrpose-tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``ops``, ``models``, ``configs``,
``utils``, ``tools``) and its module and parameter names follow the original
DETRPose ``state_dict`` keys, so zoo checkpoints load with
``load_state_dict(strict=True)``.

- ``ops``      plain PyTorch numerics (positional embeddings, FDR, bilinear
               sampling, multi-scale deformable attention) and, under
               ``ops/cuda``, the wrappers of the hand-written CUDA kernels whose
               sources live in ``csrc/``.
- ``models``   ``nn.Module``s: HGNetv2 backbone, HybridEncoder, deformable pose
               decoder, post-process (eval and train paths).
- ``train``    CDN denoising queries, the matcher, the criterion, the
               optimiser and EMA, and the Trainer (epochs, evaluation,
               checkpoints); ``parallel`` the training step.
- ``data``     COCO / CrowdPose keypoint datasets, augmentations, the batch
               loader and the OKS AP evaluator (host-side numpy and PIL).
- ``core``     the lazy config system that reads ``configs/*/*.py``.
- ``configs``  the N/S/M/L/X presets and ``build_model`` (train or deploy form).
- ``utils``    weight carry from the JAX variables and zoo ``.pth`` loading,
               deploy re-parameterisation, CUDA-event timing, checkpoints,
               meters, the evaluator's native match.
- ``tools``    ``infer.build_pipeline``, the serving entry point; the
               ``train`` (training and evaluation), ``benchmark`` (forward and
               training step), ``pallas_bench`` and ``export`` command lines.

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
