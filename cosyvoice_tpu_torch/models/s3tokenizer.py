"""S3 speech tokenizer v2: 16 kHz audio -> 25 Hz speech token ids.

Port of cosyvoice_tpu/models/s3tokenizer.py.
  * `whisper_log_mel`: reflect pad 200, n_fft 400, hop 160, the last frame
    dropped, 128 Slaney mels, log10 floored at max - 8, then (x + 4) / 4.
  * `S3TokenizerV2`: a whisper-style encoder (two convolutions, the second of
    stride 2, with tanh-gelu; sinusoidal positions; pre-LN blocks whose
    attention masks the pad frames and whose key projection has no bias;
    `ln_post`), a 50 -> 25 Hz average of frame pairs and an FSQ head (8
    dims x 3 levels = 6561 ids); ids past a row's length are 0.
  * `make_s3_frontend_fn`: pads the prompt to a 2 s bucket and zeroes the pad
    frames' mel, so a padded prompt gives the JAX package's ids.
The modules carry the whisper-lineage names of a released
`speech_tokenizer_v2.onnx` (`encoder.conv1`, `encoder.blocks.{i}.attn.query`,
..., `quantizer.project_in`).  Like the JAX package, the activations are
tanh-approximate gelu and the LayerNorms take eps 1e-6 (flax's defaults).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosyvoice_tpu_torch.ops.mel import mel_filterbank
from cosyvoice_tpu_torch.ops.stft import hann_window, reflect_pad
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name
from cosyvoice_tpu_torch.utils.onnx_io import read_onnx_tensors


@dataclass(frozen=True)
class S3Config:
    n_mels: int = 128
    dim: int = 1280
    heads: int = 20
    layers: int = 12
    fsq_dim: int = 8
    fsq_levels: int = 3
    stride2: int = 2  # conv2 stride: 100 Hz mel -> 50 Hz; pair pooling -> 25 Hz


def whisper_log_mel(wav_16k: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """[S] at 16 kHz -> [S // 160, n_mels] whisper-normalized log10 mel (fp32).

    The spectrum (an FFT) and the mel are taken in float64: float32 DFT sums
    move the log of the weakest bands by up to 6e-5, more than the JAX
    package's own float32 result (which sums in another order) lies from
    the exact one."""
    y = reflect_pad(wav_16k.double(), 200, 200)
    frames = y.unfold(-1, 400, 160)[:-1] * hann_window(400, torch.float64, y.device)
    spec = torch.fft.rfft(frames, dim=-1)                # whisper drops the last frame
    mag2 = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_filterbank(16000, 400, n_mels, 0.0, 8000.0),
                         dtype=torch.float64, device=y.device)
    logspec = torch.log10((mag2 @ fb.T).clamp_min(1e-10))
    logspec = torch.maximum(logspec, logspec.max() - 8.0)
    return ((logspec + 4.0) / 4.0).float()


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class S3Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, bias):
        B, T, D = x.shape
        q, k, v = (proj(x).reshape(B, T, self.heads, -1).transpose(1, 2)
                   for proj in (self.query, self.key, self.value))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.out(o.transpose(1, 2).reshape(B, T, D))


class S3AttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(dim, eps=1e-6)
        self.attn = S3Attention(dim, heads)
        self.mlp_ln = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(approximate="tanh"),
                                 nn.Linear(4 * dim, dim))

    def forward(self, x, bias):
        x = x + self.attn(self.attn_ln(x), bias)
        return x + self.mlp(self.mlp_ln(x))


class S3Encoder(nn.Module):
    def __init__(self, cfg: S3Config):
        super().__init__()
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.dim, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.dim, cfg.dim, 3, stride=cfg.stride2, padding=1)
        self.blocks = nn.ModuleList([S3AttentionBlock(cfg.dim, cfg.heads)
                                     for _ in range(cfg.layers)])
        self.ln_post = nn.LayerNorm(cfg.dim, eps=1e-6)


class FSQ(nn.Module):
    """Finite scalar quantization: project, bound with tanh, round each dim."""

    def __init__(self, in_dim: int, dim: int = 8, levels: int = 3):
        super().__init__()
        self.levels = levels
        self.project_in = nn.Linear(in_dim, dim)
        self.register_buffer("weights", levels ** torch.arange(dim), persistent=False)

    def forward(self, x):
        half = (self.levels - 1) / 2.0
        digits = torch.round(torch.tanh(self.project_in(x)) * half + half).long()
        return (digits * self.weights).sum(dim=-1)


class S3TokenizerV2(nn.Module):
    def __init__(self, cfg: S3Config = S3Config()):
        super().__init__()
        self.cfg = cfg
        self.encoder = S3Encoder(cfg)
        self.quantizer = FSQ(cfg.dim, cfg.fsq_dim, cfg.fsq_levels)
        self.eval()

    def forward(self, mel: torch.Tensor, mel_len: torch.Tensor):
        """mel [B, T, n_mels] (whisper-normalized), mel_len [B] ->
        (ids [B, T'' // 2] with 0 past each row's length, lengths [B])."""
        enc, cfg = self.encoder, self.cfg
        x = F.gelu(enc.conv1(mel.transpose(1, 2)), approximate="tanh")
        x = F.gelu(enc.conv2(x), approximate="tanh").transpose(1, 2)
        B, T, _ = x.shape
        x = x + torch.as_tensor(_sinusoids(T, cfg.dim), device=x.device)
        out_len = mel_len // cfg.stride2
        keep = torch.arange(T, device=x.device)[None, :] < out_len[:, None]
        bias = torch.zeros(B, 1, 1, T, device=x.device).masked_fill(
            ~keep[:, None, None, :], -1e9)
        for blk in enc.blocks:
            x = blk(x, bias)
        x = enc.ln_post(x)
        x = x[:, : (T // 2) * 2].reshape(B, T // 2, 2, cfg.dim).mean(dim=2)
        tokens = self.quantizer(x)
        tok_len = out_len // 2
        valid = torch.arange(tokens.shape[1], device=x.device)[None, :] < tok_len[:, None]
        return torch.where(valid, tokens, 0), tok_len


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def s3_tokenize(model: S3TokenizerV2, wav_16k: np.ndarray) -> np.ndarray:
    """<= 30 s of 16 kHz audio at its exact length -> ids."""
    if len(wav_16k) / 16000 > 30:
        raise ValueError("prompt audio must be <= 30 s")
    with torch.inference_mode():
        mel = whisper_log_mel(torch.as_tensor(np.asarray(wav_16k, np.float32),
                                              device=_device(model)), model.cfg.n_mels)
        toks, n = model(mel[None], torch.tensor([mel.shape[0]], device=mel.device))
        return toks[0, : int(n[0])].cpu().numpy()


def make_s3_frontend_fn(model: S3TokenizerV2,
                        bucket_s: float = 2.0) -> Callable[[np.ndarray], np.ndarray]:
    """`wav16k [S] -> ids [T]` for CosyVoiceFrontEnd.  The wav is zero-padded
    to a `bucket_s`-second bucket, as in the JAX package (whose compiles it
    bounds), and the pad frames' mel is zeroed: the convolutions then see
    the zeros of their own edge padding, the attention masks the pad
    frames, and the ids equal the JAX package's for the same prompt."""
    def tokenize(wav_16k: np.ndarray) -> np.ndarray:
        s = len(wav_16k)
        if s / 16000 > 30:
            raise ValueError("prompt audio must be <= 30 s")
        bucket = max(int(bucket_s * 16000), 160)
        wav = np.pad(np.asarray(wav_16k, np.float32), (0, -(-s // bucket) * bucket - s))
        with torch.inference_mode():
            mel = whisper_log_mel(torch.as_tensor(wav, device=_device(model)),
                                  model.cfg.n_mels)
            t_true = s // 160
            mel[t_true:] = 0.0
            toks, n = model(mel[None], torch.tensor([t_true], device=mel.device))
            return toks[0, : int(n[0])].cpu().numpy()

    return tokenize


def _source_prefix(tensors: dict, *candidates: str) -> str:
    """The first candidate module prefix whose `.weight` the file holds."""
    for c in candidates:
        if f"{c}.weight" in tensors:
            return c
    raise KeyError(f"none of {candidates} in the weights (they hold e.g. {sorted(tensors)[:8]})")


def import_s3tokenizer_state(tensors: dict, cfg: S3Config = S3Config()) -> dict:
    """Whisper-named weights (bare or `encoder.`-prefixed; the FSQ projection
    as `project_in` or `project_down`) -> the port's state_dict.  The fixed
    `positional_embedding` is not read (the module recomputes it)."""
    out = {}
    for prefix, has_bias in _module_prefixes(cfg):
        if prefix == "quantizer.project_in":
            src = _source_prefix(tensors, prefix, "quantizer.project_down")
        else:
            src = _source_prefix(tensors, prefix, prefix.removeprefix("encoder."))
        out[f"{prefix}.weight"] = tensors[f"{src}.weight"]
        if has_bias:
            out[f"{prefix}.bias"] = tensors[f"{src}.bias"]
    return out


def _module_prefixes(cfg: S3Config) -> list:
    """(module prefix, has a bias) of every weight-holding module."""
    mods = [("encoder.conv1", True), ("encoder.conv2", True)]
    for i in range(cfg.layers):
        b = f"encoder.blocks.{i}"
        mods += [(f"{b}.attn_ln", True), (f"{b}.attn.query", True), (f"{b}.attn.key", False),
                 (f"{b}.attn.value", True), (f"{b}.attn.out", True), (f"{b}.mlp_ln", True),
                 (f"{b}.mlp.0", True), (f"{b}.mlp.2", True)]
    return mods + [("encoder.ln_post", True), ("quantizer.project_in", True)]


def import_s3tokenizer_onnx(path: str, cfg: S3Config = S3Config(),
                            device=None) -> S3TokenizerV2:
    """A released `speech_tokenizer_v2.onnx` -> S3TokenizerV2 on `device`
    (None: the GPU); a missing weight raises KeyError."""
    from cosyvoice_tpu_torch.device import resolve_device

    model = S3TokenizerV2(cfg)
    load_by_name(model, import_s3tokenizer_state(read_onnx_tensors(path), cfg), path)
    return model.to(resolve_device(device)).eval()


def s3tokenizer_state_dict(model: S3TokenizerV2) -> dict:
    """The module's weights under the whisper names, as numpy arrays in torch
    layouts: what `write_onnx_tensors` needs to write a released-format file."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
