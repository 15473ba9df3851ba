"""Down-sampling as weight masking (port of
``photon_tpu/data/sampling.py``; DownSampler.scala:68,
BinaryClassificationDownSampler.scala:32, DefaultDownSampler.scala:41).

A dropped row gets weight 0 instead of leaving the batch, so every
shape stays put:
- binary tasks keep every positive, keep a negative where its uniform
  draw is under ``rate`` and scale its weight by 1/rate;
- other tasks keep a row where its draw is under ``rate``, with no
  rescale.

The draws come from a ``torch.Generator`` on the labels' device seeded
with ``seed`` (``draw_uniforms``), apart from the mask that takes them,
so a test can hand the mask the reference's uniforms. JAX's threefry
bits are not reproduced here.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.data.dataset import GLMBatch

_POS = 0.5


def draw_uniforms(n: int, seed: int, like: torch.Tensor) -> torch.Tensor:
    """[n] uniforms in [0, 1) in ``like``'s dtype, on its device."""
    gen = torch.Generator(device=like.device).manual_seed(int(seed))
    return torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)


def _check(rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1): {rate}")


def downsample_binary_negatives(batch: GLMBatch, rate: float,
                                uniforms: torch.Tensor) -> GLMBatch:
    """Negative down-sampling with weight rescale
    (BinaryClassificationDownSampler.scala:50-54)."""
    _check(rate)
    keep = uniforms < rate
    zero = torch.zeros_like(batch.weights)
    weights = torch.where(batch.labels > _POS, batch.weights,
                          torch.where(keep, batch.weights / rate, zero))
    return batch.with_weights(weights)


def downsample_uniform(batch: GLMBatch, rate: float,
                       uniforms: torch.Tensor) -> GLMBatch:
    """Uniform down-sampling, no rescale (DefaultDownSampler.scala)."""
    _check(rate)
    keep = uniforms < rate
    return batch.with_weights(torch.where(keep, batch.weights,
                                          torch.zeros_like(batch.weights)))


def downsample(batch: GLMBatch, rate: float, seed: int, *,
               binary: bool) -> GLMBatch:
    """Mask ``batch`` by draws seeded with ``seed``. A row-sharded batch
    takes its rank's share of the draws over every rank's rows, so the
    mask is the one the whole padded batch would get."""
    n = batch.num_samples
    if batch.mesh is None:
        u = draw_uniforms(n, seed, batch.labels)
    else:
        lo = batch.mesh.rank * n
        u = draw_uniforms(n * batch.mesh.size, seed, batch.labels)[lo:lo + n]
    if binary:
        return downsample_binary_negatives(batch, rate, u)
    return downsample_uniform(batch, rate, u)
