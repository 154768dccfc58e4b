"""Raw-audio dataloader: features are computed ON DEVICE inside the
jitted step (MFCC + per-speaker CMVN fused with the model forward).

This replaces the reference's *offline* Kaldi feature chain
(compute-mfcc-feats -> apply-cmvn -> text ark -> .npy files, SURVEY §2.4)
with an on-device pipeline: the loader ships padded raw audio +
per-utterance CMVN statistics; `ast_tpu.ops.fbank` turns them into
normalized 13-dim MFCC on the device as a chain of matmuls, fused by XLA
into the encoder's first convolution.

Select with ``data.features: "wav"``.  Layout:
  <speech_path>/<set_key>/<utt>.npy   float32 1-D raw audio (8 kHz), or
  <speech_path>/<set_key>/<utt>.wav   PCM wav (stdlib reader), or
  <speech_path>/<set_key>/<utt>.sph   NIST SPHERE (pcm/ulaw/
                                      embedded-shorten; LDC Fisher)
  <speech_path>/cmvn.stats            optional pickle
      {"utt2spk": {utt: spk}, "stats": {spk: {"mean": (13,), "std": (13,)}}}
  absent stats => identity normalization.

Bucketing still uses the info dict's frame counts ("sp"), so the batch
shape policy is unchanged: bucket b carries T=(b+1)*width frames, i.e.
(T-1)*shift + frame_len audio samples.
"""

import os
import pickle
import wave

import numpy as np

from ast_tpu.data.dataloader import FisherDataLoader
from ast_tpu.ops.fbank import MfccConfig, num_frames


def read_wav(path, channel=None, with_rate=False):
    """PCM wav -> float32 mono in [-1, 1] (stdlib only).

    ``channel``: 0-based channel to keep; None averages channels.
    ``with_rate=True`` additionally returns the file's sample rate."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
        rate = w.getframerate()
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        # 24-bit PCM: sign-extend 3-byte little-endian samples via i32
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = (i32 << 8) >> 8  # sign extend bit 23
        x = i32.astype(np.float32) / 8388608.0
    elif width == 1:
        # wav 8-bit is unsigned
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    else:
        raise ValueError(
            f"{path}: unsupported wav sample width {width} bytes")
    if channel is not None and channel >= channels:
        raise ValueError(
            f"{path}: channel {channel} requested but file has "
            f"{channels} channel(s)")
    if channels > 1:
        x = x.reshape(-1, channels)
        x = x[:, channel] if channel is not None else x.mean(axis=1)
    x = np.ascontiguousarray(x, dtype=np.float32)
    return (x, rate) if with_rate else x


def _ulaw_to_linear(u8):
    """G.711 mu-law bytes -> int16-range PCM (vectorized)."""
    u = np.invert(np.asarray(u8, dtype=np.uint8))
    sign = (u & 0x80) != 0
    exponent = (u >> 4) & 0x07
    mantissa = (u & 0x0F).astype(np.int32)
    magnitude = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


def read_sph(path, channel=None, with_rate=False):
    """NIST SPHERE audio -> float32 mono in [-1, 1] (stdlib only).

    The LDC Fisher corpus ships SPHERE files that the reference pipeline
    decodes with sph2pipe (reference: fisher/kaldi/local/fsp_data_prep.sh:
    37-41).  Supported codings: uncompressed PCM (1/2-byte, either
    endianness), mu-law, and shorten v2 compression ("embedded-shorten"
    — the coding the real LDC Fisher tapes use; decoded natively by
    :mod:`ast_tpu.data.shorten`, no sph2pipe needed).

    ``channel``: 0-based channel to keep (Fisher is 2-channel, one per
    speaker); None averages channels.  ``with_rate=True`` additionally
    returns the header's sample_rate.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        f.seek(header_size)
        raw = f.read()

    fields = {}
    for line in header.splitlines()[2:]:
        line = line.strip()
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) == 3:
            name, typ, value = parts
            fields[name] = int(value) if typ == "-i" else value

    coding = str(fields.get("sample_coding", "pcm")).lower()
    n_bytes = int(fields.get("sample_n_bytes", 2))
    channels = int(fields.get("channel_count", 1))
    byte_format = str(fields.get("sample_byte_format", "01"))
    n_samples = int(fields.get("sample_count", 0))

    shorten_ftype = None
    if "shorten" in coding:
        # embedded-shorten: the waveform section is a shorten v2
        # stream; decode it to the original sample bytes, then fall
        # through to the ulaw/pcm branches below (the header's
        # sample_coding prefix describes the DECODED bytes)
        from ast_tpu.data import shorten as _shorten
        stream = _shorten.decode(raw)
        shorten_ftype = stream.ftype
        raw = _shorten.samples_to_bytes(stream)
    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        x = _ulaw_to_linear(np.frombuffer(raw, dtype=np.uint8))
        x = x.astype(np.float32) / 32768.0
    elif coding.startswith("pcm"):
        if n_bytes == 2:
            dtype = ">i2" if byte_format == "10" else "<i2"
            if shorten_ftype is not None:
                # the stream's own type is authoritative for endianness
                from ast_tpu.data import shorten as _shorten
                if shorten_ftype == _shorten.TYPE_S16HL:
                    dtype = ">i2"
                elif shorten_ftype == _shorten.TYPE_S16LH:
                    dtype = "<i2"
            x = np.frombuffer(raw, dtype=dtype).astype(np.float32) / 32768.0
        elif n_bytes == 1:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        else:
            raise ValueError(
                f"{path}: unsupported pcm sample_n_bytes={n_bytes}")
    else:
        raise ValueError(f"{path}: unsupported sample_coding={coding!r}")

    if n_samples:
        x = x[: n_samples * channels]
    if channel is not None and channel >= channels:
        raise ValueError(
            f"{path}: channel {channel} requested but header says "
            f"channel_count {channels}")
    if channels > 1:
        x = x.reshape(-1, channels)
        x = x[:, channel] if channel is not None else x.mean(axis=1)
    x = np.ascontiguousarray(x, dtype=np.float32)
    if with_rate:
        return x, int(fields.get("sample_rate", 8000))
    return x


def extract_segments(segments_path, audio_dir, out_dir,
                     channel_map=None, rate=8000, allow_missing=False):
    """Slice conversation-level audio into per-utterance files by a
    Kaldi segments table — the audio-domain `extract-segments`
    equivalent (reference pipeline: fisher/kaldi/train_all.sh:32-44 and
    create_mfccs.sh:36-44 do this with Kaldi binaries before feature
    extraction; this closes the last manual Kaldi step in
    raw-LDC-tape -> wav-mode training).

    ``segments_path``: Kaldi format, one `utt reco start_sec end_sec`
    per line.  ``audio_dir``: contains `<reco>.sph|.wav|.npy`.
    ``channel_map``: optional {reco: channel} (or a path to a file of
    `reco channel` lines) — Fisher SPHERE files are 2-channel, one per
    speaker; unmapped recos are channel-averaged (applies to .sph, .wav
    and (T, channels) .npy alike).  Writes `<out_dir>/<utt>.npy`
    float32 mono audio at ``rate``; a .sph/.wav whose header rate
    disagrees with ``rate`` is an error (segment seconds would slice at
    wrong sample offsets).  Returns the number of utterances written.
    """
    if isinstance(channel_map, str):
        cmap = {}
        with open(channel_map) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    cmap[parts[0]] = int(parts[1])
        channel_map = cmap
    channel_map = channel_map or {}

    by_reco = {}
    with open(segments_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            utt, reco, start, end = parts[:4]
            by_reco.setdefault(reco, []).append(
                (utt, float(start), float(end)))

    os.makedirs(out_dir, exist_ok=True)
    n_written = 0
    for reco, segs in sorted(by_reco.items()):
        chan = channel_map.get(reco)
        path = None
        for ext in (".sph", ".wav", ".npy"):
            cand = os.path.join(audio_dir, reco + ext)
            if os.path.exists(cand):
                path = cand
                break
        if path is None and reco[-2:] in ("-A", "-B"):
            # Fisher convention: reco "{call}-{A|B}" is side A/B of the
            # 2-channel tape "{call}.sph" (the reference's wav.scp maps
            # side A -> sph2pipe -c 1, B -> -c 2; fsp_data_prep.sh:165)
            for ext in (".sph", ".wav", ".npy"):
                cand = os.path.join(audio_dir, reco[:-2] + ext)
                if os.path.exists(cand):
                    path = cand
                    if chan is None:
                        chan = 0 if reco.endswith("-A") else 1
                    break
        if path is None:
            if allow_missing:
                print(f"extract-segments: no audio for reco {reco} "
                      f"({len(segs)} segments skipped)", flush=True)
                continue
            raise FileNotFoundError(
                f"no audio for recording {reco!r} in {audio_dir} "
                f"(.sph/.wav/.npy); pass --allow-missing to skip")
        if path.endswith(".sph"):
            x, file_rate = read_sph(path, channel=chan, with_rate=True)
        elif path.endswith(".wav"):
            x, file_rate = read_wav(path, channel=chan, with_rate=True)
        else:
            x = np.load(path).astype(np.float32)
            file_rate = None  # .npy carries no rate metadata
            if x.ndim == 2:   # (T, channels)
                if chan is not None and chan >= x.shape[1]:
                    raise ValueError(
                        f"{path}: channel {chan} requested but array has "
                        f"{x.shape[1]} channel(s)")
                x = x[:, chan] if chan is not None else x.mean(axis=1)
            elif x.ndim == 1 and chan not in (None, 0):
                # a mapped non-zero channel on mono audio means the
                # recording was pre-mixed — slicing it would train on
                # the wrong speaker's side, so fail loudly
                raise ValueError(
                    f"{path}: channel_map assigns channel {chan} to "
                    f"{reco} but its audio is 1-D (mono)")
            elif x.ndim != 1:
                raise ValueError(
                    f"{path}: expected 1-D or (T, channels) audio, "
                    f"got shape {x.shape}")
        if file_rate is not None and file_rate != rate:
            raise ValueError(
                f"{path}: file sample rate {file_rate} != --rate {rate}; "
                "segment times would slice at wrong offsets (and the "
                "on-device MFCC front-end assumes 8 kHz telephone "
                "audio) — resample offline or pass the true rate")
        for utt, start, end in segs:
            s0 = max(0, int(round(start * rate)))
            s1 = min(len(x), int(round(end * rate)))
            if s1 <= s0:
                print(f"extract-segments: empty segment {utt} "
                      f"[{start:.2f}, {end:.2f}] in {reco}", flush=True)
                continue
            np.save(os.path.join(out_dir, f"{utt}.npy"),
                    np.ascontiguousarray(x[s0:s1], dtype=np.float32))
            n_written += 1
    return n_written


def samples_for_frames(cfg: MfccConfig, t_frames: int) -> int:
    """Audio samples needed to produce exactly ``t_frames`` frames."""
    if t_frames <= 0:
        return 0
    return (t_frames - 1) * cfg.shift + cfg.frame_len


class WavDataLoader(FisherDataLoader):
    """Yields raw audio + CMVN stats instead of precomputed features.

    Batch dict adds: "audio" (B, S) f32, "cmvn_mean"/"cmvn_std" (B, D);
    "X" is absent — the trainer composes fbank+CMVN into the jitted step.
    """

    def __init__(self, data_cfg, model_dir, seed="seed", mfcc_cfg=None,
                 cache_features=True):
        super().__init__(data_cfg, model_dir, seed, cache_features)
        self.mfcc_cfg = mfcc_cfg or MfccConfig()
        stats_path = os.path.join(data_cfg["speech_path"], "cmvn.stats")
        if os.path.exists(stats_path):
            with open(stats_path, "rb") as f:
                blob = pickle.load(f)
            self.utt2spk = blob["utt2spk"]
            self.cmvn = blob["stats"]
        else:
            self.utt2spk = {}
            self.cmvn = {}

    def _load_audio(self, utt, set_key):
        key = (set_key, utt, "audio")
        if self.cache_features and key in self._cache:
            return self._cache[key]
        base = os.path.join(self.data_cfg["speech_path"], set_key)
        npy = os.path.join(base, f"{utt}.npy")
        wav = os.path.join(base, f"{utt}.wav")
        sph = os.path.join(base, f"{utt}.sph")
        if os.path.exists(npy):
            x = np.load(npy).astype(np.float32).reshape(-1)
        elif os.path.exists(wav):
            x = read_wav(wav)
        else:
            x = read_sph(sph)
        if self.cache_features:
            self._cache[key] = x
        return x

    def get_batch(self, batch_size, set_key, train, labels=False,
                  pad_batch=True, curriculum=False, epoch=None,
                  group_runs=1, tail_shrink=0, index_cache=None):
        if index_cache is not None:
            # the trainer rejects hbm_cache+wav at init; reaching here
            # with a cache means a caller bypassed that check
            raise ValueError("wav mode has no feature block to cache")
        D = self.mfcc_cfg.n_ceps
        for batch in super().get_batch(batch_size, set_key, train, labels,
                                       pad_batch, curriculum, epoch,
                                       group_runs, tail_shrink,
                                       _skip_speech=True):
            b = batch["bucket"]
            num_b = self.buckets[set_key]["num_b"]
            width_b = self.buckets[set_key]["width_b"]
            T = ((num_b + 1) * width_b if b == num_b - 1
                 else (b + 1) * width_b)
            S = samples_for_frames(self.mfcc_cfg, T)
            B = batch["X_rows"]
            audio = np.zeros((B, S), dtype=np.float32)
            mean = np.zeros((B, D), dtype=np.float32)
            std = np.ones((B, D), dtype=np.float32)
            from ast_tpu.ops.fbank import num_frames
            for j, u in enumerate(batch["utts"]):
                x = self._load_audio(u, set_key)[:S]
                audio[j, : len(x)] = x
                # true FEATURE frame count from the audio sample count —
                # in-graph SpecAugment can't infer it (CMVN'd silence is
                # nonzero), so the loader supplies it
                batch["frame_len"][j] = min(T, num_frames(
                    self.mfcc_cfg, len(x)))
                spk = self.utt2spk.get(u)
                if spk is not None and spk in self.cmvn:
                    mean[j] = self.cmvn[spk]["mean"]
                    std[j] = self.cmvn[spk]["std"]
            batch.pop("X", None)
            batch.pop("X_rows", None)
            batch["audio"] = audio
            batch["cmvn_mean"] = mean
            batch["cmvn_std"] = std
            batch["n_frames"] = T
            yield batch
