"""On-device MFCC / log-mel filterbank + CMVN feature extraction.

On-device replacement for the reference's offline Kaldi C++ feature chain
(reference: linking_files/fisher/mfcc.conf — 13-dim MFCC, 8 kHz,
--use-energy=false; fisher/create_mfccs.sh:33-44 apply-cmvn
--norm-vars=true per speaker; SURVEY §2.4): the whole chain — framing,
DC removal, pre-emphasis, povey window, spectrum, mel filterbank, DCT,
liftering, CMVN — runs batched on device.

Design: the DFT is expressed as two real matmuls against precomputed
cos/sin bases, and the mel projection and DCT are matmuls too, so the
entire extractor is a chain of matmuls + cheap elementwise ops that XLA
fuses; there is no FFT butterfly, no host round-trip, and the
bases are constants folded at compile time.  Frame extraction is a single
gather with a static (n_frames, frame_len) index matrix.

Defaults mirror Kaldi's compute-mfcc-feats for 8 kHz telephone speech
(frame 25 ms / shift 10 ms, 23 mel bins on [20 Hz, Nyquist], 13 ceps,
cepstral lifter 22, snip-edges, dither off).  Numerical parity is pinned
against committed golden fixtures (tests/fixtures/kaldi_mfcc.npz) produced
by an independent per-frame Kaldi-pipeline implementation
(scripts/make_kaldi_fixtures.py); training uses either these on-device
features or precomputed .npy features interchangeably.
"""

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp


class MfccConfig:
    def __init__(self, sample_rate=8000, frame_ms=25.0, shift_ms=10.0,
                 n_mels=23, n_ceps=13, preemph=0.97, remove_dc=True,
                 window="povey", low_freq=20.0, high_freq=0.0,
                 cepstral_lifter=22.0, log_floor=None):
        self.sample_rate = sample_rate
        self.frame_len = int(sample_rate * frame_ms / 1000)
        self.shift = int(sample_rate * shift_ms / 1000)
        self.n_fft = 1 << (self.frame_len - 1).bit_length()  # next pow2
        self.n_mels = n_mels
        self.n_ceps = n_ceps
        self.preemph = preemph
        self.remove_dc = remove_dc
        self.window = window
        self.low_freq = low_freq
        self.high_freq = high_freq if high_freq > 0 else sample_rate / 2
        self.cepstral_lifter = cepstral_lifter
        # Kaldi floors mel energies at FLT_EPSILON before the log
        self.log_floor = (float(np.finfo(np.float32).eps)
                          if log_floor is None else log_floor)


def _window_fn(cfg):
    n = cfg.frame_len
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    else:
        w = np.ones(n)
    return w.astype(np.float32)


def _mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _mel_filterbank(cfg):
    """Kaldi-style triangular mel filterbank matrix (n_bins, n_mels)."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft
    mel_low = _mel_scale(cfg.low_freq)
    mel_high = _mel_scale(cfg.high_freq)
    mel_pts = np.linspace(mel_low, mel_high, cfg.n_mels + 2)
    mel_f = _mel_scale(fft_freqs)
    fb = np.zeros((n_bins, cfg.n_mels), dtype=np.float32)
    for m in range(cfg.n_mels):
        left, center, right = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _dct_matrix(cfg):
    """Orthonormal DCT-II (n_mels, n_ceps) with cepstral liftering folded
    into the matrix (both are linear)."""
    n, k = cfg.n_mels, cfg.n_ceps
    j = np.arange(n)[:, None]
    i = np.arange(k)[None, :]
    dct = np.sqrt(2.0 / n) * np.cos(math.pi * (j + 0.5) * i / n)
    dct[:, 0] = 1.0 / math.sqrt(n)
    if cfg.cepstral_lifter > 0:
        q = cfg.cepstral_lifter
        lifter = 1.0 + 0.5 * q * np.sin(math.pi * np.arange(k) / q)
        dct = dct * lifter[None, :]
    return dct.astype(np.float32)


def _dft_bases(cfg):
    """Real/imag DFT bases (frame_len, n_bins): the frame is implicitly
    zero-padded to n_fft by truncating the basis rows."""
    n_bins = cfg.n_fft // 2 + 1
    t = np.arange(cfg.frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * t * k / cfg.n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def num_frames(cfg, n_samples):
    """snip-edges frame count."""
    if n_samples < cfg.frame_len:
        return 0
    return 1 + (n_samples - cfg.frame_len) // cfg.shift


@functools.partial(jax.jit, static_argnums=(1, 2))
def _logmel_impl(audio, cfg, n_fr, consts):
    """Shared frame/DC/pre-emphasis/window/DFT/mel pipeline (the MFCC
    chain minus the final DCT) — the single copy both feature types
    compile from."""
    cos_b, sin_b, win, fb, _ = consts
    idx = (jnp.arange(n_fr)[:, None] * cfg.shift
           + jnp.arange(cfg.frame_len)[None, :])
    frames = audio[..., idx]                      # (..., F, frame_len)
    if cfg.remove_dc:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    if cfg.preemph > 0:
        prev = jnp.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
        frames = frames - cfg.preemph * prev
    frames = frames * win
    re = frames @ cos_b                            # (..., F, n_bins)
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ fb
    return jnp.log(jnp.maximum(mel, cfg.log_floor))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _mfcc_impl(audio, cfg, n_fr, consts):
    return _logmel_impl(audio, cfg, n_fr, consts) @ consts[4]


class MfccExtractor:
    """Batched on-device MFCC: audio (..., n_samples) -> (..., F, n_ceps)."""

    def __init__(self, cfg=None):
        self.cfg = cfg or MfccConfig()
        cos_b, sin_b = _dft_bases(self.cfg)
        self.consts = (
            jnp.asarray(cos_b), jnp.asarray(sin_b),
            jnp.asarray(_window_fn(self.cfg)),
            jnp.asarray(_mel_filterbank(self.cfg)),
            jnp.asarray(_dct_matrix(self.cfg)),
        )

    def __call__(self, audio):
        audio = jnp.asarray(audio, jnp.float32)
        n_fr = num_frames(self.cfg, audio.shape[-1])
        if n_fr == 0:
            return jnp.zeros(audio.shape[:-1] + (0, self.cfg.n_ceps))
        return _mfcc_impl(audio, self.cfg, n_fr, self.consts)

    def logmel(self, audio):
        """Log-mel filterbank features (the MFCC chain minus the DCT);
        jitted via the same shared pipeline as ``__call__``."""
        audio = jnp.asarray(audio, jnp.float32)
        n_fr = num_frames(self.cfg, audio.shape[-1])
        if n_fr == 0:
            return jnp.zeros(audio.shape[:-1] + (0, self.cfg.n_mels))
        return _logmel_impl(audio, self.cfg, n_fr, self.consts)


# ---------------------------------------------------------------------------
# CMVN (reference: apply-cmvn --norm-vars=true, per speaker)
# ---------------------------------------------------------------------------

def compute_cmvn_stats(feature_arrays):
    """Accumulate per-group CMVN stats from a list of (T, D) arrays.

    Returns {"mean": (D,), "std": (D,), "count": n} — the per-speaker
    statistics Kaldi's compute_cmvn_stats.sh produces.
    """
    total = None
    total_sq = None
    count = 0
    for x in feature_arrays:
        x = np.asarray(x, np.float64)
        s = x.sum(axis=0)
        sq = (x * x).sum(axis=0)
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += x.shape[0]
    if not count:
        # a speaker group whose utterances were all filtered out would
        # otherwise die on a bare TypeError/ZeroDivisionError in numpy
        raise ValueError(
            "compute_cmvn_stats: no frames to accumulate (empty list "
            "or every array has zero rows)")
    mean = total / count
    var = total_sq / count - mean * mean
    return {
        "mean": mean.astype(np.float32),
        "std": np.sqrt(np.maximum(var, 1e-10)).astype(np.float32),
        "count": count,
    }


def apply_cmvn(feats, stats, norm_vars=True):
    """Normalize (…, T, D) features with precomputed stats (jittable)."""
    out = feats - stats["mean"]
    if norm_vars:
        out = out / stats["std"]
    return out
