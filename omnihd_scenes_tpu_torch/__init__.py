"""PyTorch/CUDA port of the OmniHD-Scenes BEVFusion serving path.

Module names mirror :mod:`omnihd_scenes_tpu` so every part can be held
against its JAX counterpart; the JAX package stays the reference.  The
port imports ``torch`` and never ``jax`` or ``flax``.

Entry point: :class:`omnihd_scenes_tpu_torch.serve.predictor.Predictor`.
The one hand-written GPU kernel on the path, the LSS sampling view
transform, lives in :mod:`omnihd_scenes_tpu_torch.kernels.lss_sample`.
"""

__version__ = '0.1.0'
