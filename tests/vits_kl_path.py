"""The VITS recipe's GAN training over several D + G pairs in both packages
on the CPU, from one init: the JAX package's own initializers (flax's
init, not a test draw), carried into the port by convert.py.  The shape is
the recipe's (cosyvoice2_vits_tts.yaml: 8 prior layers, 4 heads, the
3-7-11 resblocks, 240x upsampling to 24 kHz, 9600-sample segments, adamw
at lr 2e-4, clip 5) at a narrower width, with one conformer block a side
and no dropout (so that the two packages draw nothing differently); MPD at
periods (2, 3) + MRD at FFTs (256, 128); two rows of 2 s of a seeded
voiced signal.  The posterior noise and the segment starts of each pair
are the JAX package's draws, handed to the port.

One JSON line a pair: both packages' G loss, KL, mel L1 and D loss, and
their largest relative difference so far.  Run:

    JAX_PLATFORMS=cpu python tests/vits_kl_path.py --width 256 --pairs 5

(~2 minutes of XLA compile, then ~4 s a pair at width 256; not a pytest
module: tier 1 holds one small pair in test_torch_gan.py)."""
import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cosyvoice_tpu.models import discriminator as jd  # noqa: E402
from cosyvoice_tpu.models import vits as jv  # noqa: E402
from cosyvoice_tpu.models.conformer import ConformerConfig as JConformerConfig  # noqa: E402
from cosyvoice_tpu.ops.mel import log_mel_spectrogram as jmel  # noqa: E402
from cosyvoice_tpu.train import gan as jgan  # noqa: E402
from cosyvoice_tpu.train import optim as joptim  # noqa: E402
from cosyvoice_tpu.train import step as jstep  # noqa: E402
from cosyvoice_tpu_torch import convert  # noqa: E402
from cosyvoice_tpu_torch.models import discriminator as td  # noqa: E402
from cosyvoice_tpu_torch.models import vits as tv  # noqa: E402
from cosyvoice_tpu_torch.models.conformer import ConformerConfig as TConformerConfig  # noqa: E402
from cosyvoice_tpu_torch.ops.mel import log_mel_spectrogram as tmel  # noqa: E402
from cosyvoice_tpu_torch.train import gan as tgan  # noqa: E402
from cosyvoice_tpu_torch.train import optim as toptim  # noqa: E402
from cosyvoice_tpu_torch.train import step as tstep  # noqa: E402

SR, SEGMENT, ROWS, SECONDS = 24000, 9600, 2, 2.0
OPT = ("adamw", 2e-4, "constantlr", {})
WEIGHTS = dict(mel=45.0, feat_match=2.0, tpr=1.0, tpr_tau=0.04)


def configs(width: int, layers: int, heads: int):
    enc = dict(dim=width, heads=2, linear_units=2 * width, num_blocks=1, input_size=width,
               dropout_rate=0.0, attention_dropout_rate=0.0)
    base = dict(n_vocab=6561, spec_channels=513, inter_channels=width, hidden_channels=width,
                filter_channels=2 * width, n_heads=heads, n_layers=layers, kernel_size=3,
                resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3,
                upsample_rates=(8, 5, 3, 2), upsample_initial_channel=width,
                upsample_kernel_sizes=(16, 11, 7, 2), segment_size=SEGMENT, gin_channels=width,
                sample_rate=SR, frame_rate=25, token_upsample_ratio=4)
    return (jv.VitsConfig(**base, up_enc1=JConformerConfig(**enc),
                          up_enc2=JConformerConfig(**enc)),
            tv.VitsConfig(**base, up_enc1=TConformerConfig(**enc),
                          up_enc2=TConformerConfig(**enc)))


def seeded_batch(width: int) -> dict:
    rng = np.random.default_rng(5)
    S = int(SR * SECONDS)
    t = np.arange(S) / SR
    f0 = 100 + 120 * rng.random((ROWS, 1))
    speech = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal((ROWS, S))
    tokens = S * 25 // SR
    return {"speech": speech.astype(np.float32), "speech_len": np.full(ROWS, S, np.int32),
            "speech_token": rng.integers(0, 6561, (ROWS, tokens)).astype(np.int32),
            "speech_token_len": np.full(ROWS, tokens, np.int32),
            "embedding": rng.standard_normal((ROWS, width)).astype(np.float32)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    jcfg, tcfg = configs(args.width, args.layers, args.heads)
    hop, n_fft = jcfg.hop_length, (jcfg.spec_channels - 1) * 2
    batch = seeded_batch(args.width)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)

    jm = jv.VitsDecoder(jcfg)

    def japply(q, b, r):
        spec = jv.linear_spectrogram(b["speech"], n_fft=n_fft, hop=hop, win=n_fft)
        return jm.apply(q, b["speech_token"], b["speech_token_len"], spec,
                        b["speech_len"] // hop, b["embedding"], r, deterministic=False,
                        rngs={"dropout": r})

    spec0 = jv.linear_spectrogram(jb["speech"], n_fft=n_fft, hop=hop, win=n_fft)
    g_params = jm.init(key, jb["speech_token"], jb["speech_token_len"], spec0,
                       jb["speech_len"] // hop, jb["embedding"], key)
    jdisc = jd.MultipleDiscriminator((2, 3), (256, 128))
    wav0 = jb["speech"][:, :SEGMENT]
    d_params = jax.jit(jdisc.init)(key, wav0, wav0)
    mel_j = [lambda w: jmel(w, sr=SR)]
    jg_lf, jd_lf = jgan.make_vits_loss_fns(japply, jdisc.apply, mel_j, hop, SEGMENT,
                                           jgan.GanLossWeights(**WEIGHTS))
    jtx_g, jtx_d = (joptim.make_optimizer(*OPT, grad_clip=5.0)[0] for _ in range(2))
    j_g, j_d = jgan.make_gan_steps(jg_lf, jd_lf, jtx_g, jtx_d)

    @jax.jit
    def pair(gs, ds, b, r):
        ds, dm = j_d(ds, gs.params, b, r)
        gs, gm = j_g(gs, (ds.params, b), r)
        return gs, ds, dm, gm

    gs, ds = jstep.make_train_state(g_params, jtx_g), jstep.make_train_state(d_params, jtx_d)

    frames, T = SEGMENT // hop, batch["speech"].shape[1] // hop
    pinned = {}

    def draws(r):
        """VitsDecoder.__call__'s two draws from `r`, as the port takes them."""
        k_q, k_slice = jax.random.split(r)
        noise = jax.random.normal(k_q, (ROWS, T, jcfg.inter_channels))
        ids = (jax.random.uniform(k_slice, (ROWS,))
               * jnp.maximum(jb["speech_len"] // hop - frames, 1)).astype(jnp.int32)
        return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(ids))

    tm = tv.VitsDecoder(tcfg)
    tm.load_state_dict(convert.vits_state_from_jax(g_params), strict=True)

    def tapply(m, b, g):
        spec = tv.linear_spectrogram(b["speech"], n_fft=n_fft, hop=hop, win=n_fft)
        return m(b["speech_token"], b["speech_token_len"], spec, b["speech_len"] // hop,
                 b["embedding"], gen=g, noise=pinned["noise"], ids=pinned["ids"])

    tdisc = td.MultipleDiscriminator((2, 3), (256, 128))
    tdisc.load_state_dict(convert.discriminator_state_from_jax(d_params), strict=True)
    tg_lf, td_lf = tgan.make_vits_loss_fns(tapply, lambda d, r, f: d(r, f),
                                           [lambda w: tmel(w, sr=SR)], hop, SEGMENT,
                                           tgan.GanLossWeights(**WEIGHTS))
    ttx_g, ttx_d = (toptim.make_optimizer(*OPT, grad_clip=5.0)[0] for _ in range(2))
    t_g, t_d = tgan.make_gan_steps(tg_lf, td_lf, ttx_g, ttx_d)
    tgs, tds = tstep.make_train_state(tm, ttx_g), tstep.make_train_state(tdisc, ttx_d)
    tb = tstep.to_device(batch, "cpu")

    worst = 0.0
    with torch.enable_grad():
        for i in range(args.pairs):
            r = jax.random.fold_in(key, i)
            gs, ds, jdm, jgm = pair(gs, ds, jb, r)
            pinned["noise"], pinned["ids"] = draws(r)
            gen = torch.Generator().manual_seed(i)
            tds, tdm = t_d(tds, tgs.model, tb, gen)
            tgs, tgm = t_g(tgs, (tds.model, tb), gen)
            row = {"pair": i}
            for name, j, t in (("loss", jgm["loss"], tgm["loss"]),
                               ("kl", jgm["loss_kl"], tgm["loss_kl"]),
                               ("mel", jgm["loss_mel"], tgm["loss_mel"]),
                               ("d_loss", jdm["loss"], tdm["loss"])):
                row[f"jax_{name}"], row[f"port_{name}"] = float(j), float(t)
                worst = max(worst, abs(float(t) - float(j)) / abs(float(j)))
            row["max_rel_diff_so_far"] = worst
            print(json.dumps(row), flush=True)

if __name__ == "__main__":
    main()
