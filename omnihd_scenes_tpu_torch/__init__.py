"""PyTorch/CUDA port of the OmniHD-Scenes BEVFusion serving path.

Module names mirror :mod:`omnihd_scenes_tpu` so every part can be held
against its JAX counterpart; the JAX package stays the reference.  The
port imports ``torch`` and never ``jax`` or ``flax``.

Entry point: :class:`omnihd_scenes_tpu_torch.serve.predictor.Predictor`
(bf16, or the int8 PTQ tier after ``serve.predictor.calibrate``).  The
hand-written GPU kernels live in :mod:`omnihd_scenes_tpu_torch.kernels`:
the LSS sampling view transform (``lss_sample``), the int8 3x3 conv of
the int8 tier (``qconv``) and its bf16 dilated sibling (``bconv``).
"""

__version__ = '0.1.0'
