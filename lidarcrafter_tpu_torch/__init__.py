"""lidarcrafter_tpu_torch — the PyTorch + CUDA port of ``lidarcrafter_tpu``.

It mirrors the JAX package's layout so that each module has a counterpart
of the same name:

- ``configs``    own copy of the experiment configs the port runs.
- ``utils``      LiDAR geometry (depth codec, ray angles, range→xyz).
- ``models``     ``nn.Module`` denoiser and condition encoder (NHWC at the
                 public boundary, like the JAX package).
- ``diffusion``  log-SNR schedules and the conditional sampler (DDPM, DDIM,
                 DPM-Solver++(2M)) as Python loops over eager PyTorch.
- ``datasets``   nuScenes-format datasets, the augmentor, the threaded
                 prefetch loader, and the rollout's geometry.
- ``training``   pre/post-processing, the model/engine factory, the
                 trainers and their tracker.
- ``parallel``   data parallelism across processes (``torchrun``) on a
                 (dp, sp) mesh, ``sp`` splitting the azimuth.
- ``kernels``    hand-written CUDA kernels for Hopper (``csrc/*.cu``) with a
                 plain PyTorch version of each beside its wrapper, each a
                 ``torch.library`` operator.
- ``serving``    samplers exported with ``torch.export`` and loaded back.
- ``converters`` the data pipeline's info-pickle converters (devkit-gated).
- ``weights``    bridge from a flax parameter tree to the port's state_dict.

The package imports ``torch`` and numpy only, never JAX or the JAX package.
"""

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent, so that no entry point silently carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly"
        )
    return device
