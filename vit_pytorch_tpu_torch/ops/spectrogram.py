"""Power spectrogram for the AST audio branch, port of
``vit_pytorch_tpu/ops/spectrogram.py`` (the reference's
``torchaudio.transforms.Spectrogram``, vaat.py:11).

``torch.stft`` on the input's device (cuFFT on the card): a periodic Hann
window of ``win_length``, zero-padded centred to ``n_fft`` (left pad
``(n_fft - win_length) // 2``, as JAX :31-33), frames every ``hop_length``
(default ``win_length // 2``) after the ``pad`` zeros and the ``center``
pad, then ``|X| ** power``.  Output (b, n_fft // 2 + 1, frames), the
layout of torchaudio.  This op has no TPU kernel: JAX leaves it to XLA's
FFT.  cuFFT takes no bf16, so bf16 and f16 audio is transformed in f32 and
the spectrogram returned in the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def hann_window(win_length: int, n_fft: int, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """The periodic Hann window of ``win_length`` (``np.hanning(w + 1)[:-1]``
    in JAX, ones for a window of 1) zero-padded centred to ``n_fft``."""
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float64, device=device)
    lpad = (n_fft - win_length) // 2
    return F.pad(window, (lpad, n_fft - win_length - lpad)).to(dtype)


def spectrogram(
    audio: torch.Tensor,
    n_fft: int = 128,
    power: float = 2.0,
    win_length: int = 24,
    hop_length: Optional[int] = None,
    pad: int = 0,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """audio (b, t) -> (b, freq, frames)."""
    hop = hop_length if hop_length is not None else win_length // 2
    compute = audio.dtype if audio.dtype in (torch.float32, torch.float64) else torch.float32
    x = audio.to(compute)
    if pad > 0:
        x = F.pad(x, (pad, pad))
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode=pad_mode)[:, 0]
    window = hann_window(win_length, n_fft, dtype=compute, device=x.device)
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=window, center=False, onesided=True,
                      return_complex=True)
    return spec.abs().pow(power).to(audio.dtype)
