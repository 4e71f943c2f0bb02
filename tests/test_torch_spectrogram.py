"""The port's power spectrogram (vit_pytorch_tpu_torch/ops/spectrogram.py)
against the JAX package's (vit_pytorch_tpu/ops/spectrogram.py) and against
``torch.stft`` goldens built as tests/test_spectrogram_golden.py builds
them, on the CPU in fp32.

Inputs: audio uniform in [-1, 1) (the range of audio samples) from a numpy
seed, 2 x 4,096 samples.  Tolerance: 5e-5 absolute plus 1e-5 relative,
the JAX package's fp32 parity bar; the two FFTs differ only in their f32
summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_pytorch_tpu.ops.spectrogram import spectrogram as jax_spectrogram
from vit_pytorch_tpu_torch.ops.spectrogram import hann_window, spectrogram

ATOL, RTOL = 5e-5, 1e-5
CASES = {
    "reference": dict(),  # the reference AST's: n_fft 128, win 24, hop 12, power 2 (vaat.py:249-255)
    "win16_nfft32": dict(n_fft=32, win_length=16),
    "pad": dict(pad=7),
    "no_center": dict(center=False),
    "win1": dict(n_fft=8, win_length=1, hop_length=4),
    "magnitude": dict(power=1.0),
    "odd_hop": dict(n_fft=32, win_length=20, hop_length=7),
    "constant_pad": dict(n_fft=32, win_length=16, pad_mode="constant"),
}


def _audio(seed=0, batch=2, samples=4096):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (batch, samples)).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    kw = CASES[name]
    x = _audio()
    want = np.asarray(jax_spectrogram(jnp.asarray(x), **kw))
    got = spectrogram(torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["reference", "win16_nfft32", "no_center", "magnitude", "odd_hop"])
def test_matches_torch_stft_golden(name):
    """torch.stft with the window of ``win_length`` (torch pads it to
    n_fft itself) and its own reflect centring."""
    kw = {"n_fft": 128, "win_length": 24, "power": 2.0, "center": True, **CASES[name]}
    hop = kw.get("hop_length") or kw["win_length"] // 2
    x = torch.from_numpy(_audio(seed=1))
    golden = torch.stft(x, n_fft=kw["n_fft"], hop_length=hop, win_length=kw["win_length"],
                        window=torch.hann_window(kw["win_length"]), center=kw["center"], pad_mode="reflect",
                        normalized=False, onesided=True, return_complex=True).abs().pow(kw["power"])
    np.testing.assert_allclose(spectrogram(x, **CASES[name]).numpy(), golden.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("win_length", [1, 2, 16, 24, 25])
def test_window_is_the_jax_window(win_length):
    """The periodic Hann window equals ``np.hanning(w + 1)[:-1]`` (ones for
    w = 1) in fp32 bit for bit, zero-padded centred to n_fft as JAX pads it."""
    n_fft = 32
    want = np.hanning(win_length + 1)[:-1] if win_length > 1 else np.ones(1)
    lpad = (n_fft - win_length) // 2
    want = np.pad(want, (lpad, n_fft - win_length - lpad)).astype(np.float32)
    got = hann_window(win_length, n_fft)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # torch.hann_window computed in fp32 is within a few ulps of it; the port
    # computes it in f64 and rounds once, as numpy's window is rounded
    np.testing.assert_allclose(torch.hann_window(win_length, periodic=True).numpy(), want[lpad : lpad + win_length],
                               rtol=0, atol=2.0**-21)


def test_bf16_audio_is_transformed_in_f32():
    """cuFFT takes no bf16: bf16 audio is transformed in f32 and the
    spectrogram comes back in bf16, the f32 one rounded once."""
    x = torch.from_numpy(_audio()).bfloat16()
    got = spectrogram(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, spectrogram(x.float()).bfloat16())
