"""K7 (snake_aa) in both memory layouts, on the CPU: the wrapper's layout
decision, its launch plan at the BigVGAN recipe's four stage shapes, the CPU
route's values and strides for a channels-first x, and BigVGAN's AAAct
handing the kernel the convolutions' channels-first memory as it is.  Pure
PyTorch (the plain version against the Pallas kernel is in
tests/test_torch_bigvgan.py); the kernel itself is held on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.models import bigvgan as tb
from cosyvoice_tpu_torch.ops.kernels import snake_aa as K7

# the recipe's four stage shapes: 4 rows of up to 250 tokens after the two
# 2x encoders and rates 8, 8*5, 8*5*3 and 8*5*3*2, with 1536 / 2^(i+1) channels
STAGES = ((4, 8000, 768), (4, 40000, 384), (4, 120000, 192), (4, 240000, 96))
H100_SMS = 132


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """x's values in channels-first memory (x.transpose(1, 2) contiguous)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    alpha, beta = (torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32) * 0.3)
                   for _ in range(2))
    return x, alpha, beta


def test_memory_layout_takes_both_layouts_and_refuses_others():
    x = torch.zeros(2, 7, 5)
    assert K7.memory_layout(x) == K7.CHANNELS_LAST
    assert K7.memory_layout(_channels_first(x)) == K7.CHANNELS_FIRST
    # T = 1 or C = 1: both layouts describe the same memory
    for shape in ((2, 1, 5), (2, 7, 1)):
        assert K7.memory_layout(_channels_first(torch.zeros(shape))) in (K7.CHANNELS_LAST,
                                                                         K7.CHANNELS_FIRST)
    for bad in (x[:, ::2], _channels_first(x)[:, ::2], x.permute(1, 0, 2)):
        with pytest.raises(ValueError, match="contiguous"):
            K7.memory_layout(bad)


@pytest.mark.parametrize("shape,beta", [((2, 700, 24), True), ((1, 5, 3), False),
                                        ((3, 1, 4), True), ((2, 9, 1), True)],
                         ids=["snakebeta", "short_snake", "one_sample", "one_channel"])
def test_snake_aa_cpu_route_keeps_the_layout(shape, beta):
    """The CPU route gives a channels-first view the contiguous tensor's
    values (the same function of the same logical x), and y in x's memory
    layout: y.stride() == x.stride()."""
    x, alpha, b = _inputs(shape)
    b = b if beta else None
    want = K7.snake_aa(x, alpha, b)
    assert want.stride() == x.stride()
    xcf = _channels_first(x)
    got = K7.snake_aa(xcf, alpha, b)
    assert got.stride() == xcf.stride() and got.shape == shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(K7.snake_aa_plain(xcf, alpha, b), want, atol=0, rtol=0)


@pytest.mark.parametrize("shape", STAGES, ids=[f"T{s[1]}" for s in STAGES])
@pytest.mark.parametrize("layout", [K7.CHANNELS_FIRST, K7.CHANNELS_LAST])
def test_snake_aa_plan_covers_each_stage_shape(shape, layout):
    """The launch plan at the recipe's stage shapes on an H100: its segments
    cover T once (the last one ragged), its grid holds every working warp,
    the channels-first route takes 16-byte vectors, and every launch has at
    least WARPS_PER_SM warps an SM (four waves of 32 resident warps), so the
    smallest stage shape keeps enough loads in flight."""
    B, T, C = shape
    p = K7.plan(B, T, C, layout, H100_SMS)
    seg, segs = p["seg_len"], p["segments"]
    assert (segs - 1) * seg < T <= segs * seg
    assert p["threads"] == 32 * K7.WARPS
    assert p["warps"] >= K7.WARPS_PER_SM * H100_SMS
    if layout == K7.CHANNELS_FIRST:
        assert seg % K7.CHUNK == 0 and seg <= K7.MAX_CHUNKS * K7.CHUNK
        assert p["warps"] == B * C * segs <= p["grid"][0] * K7.WARPS
        assert p["grid"][1:] == (1, 1) and p["vector"]
    else:
        assert seg % K7.RUN == 0 and seg <= K7.MAX_RUNS * K7.RUN
        groups, blocks, batch = p["grid"]
        assert groups * 32 >= C > (groups - 1) * 32 and batch == B
        assert blocks * K7.WARPS >= segs and blocks <= 65535 and not p["vector"]


def test_snake_aa_plan_at_the_recipe():
    """The plan's numbers at the recipe's shapes: whole segments of 4 or 8
    chunks channels-first (one prologue a segment), 4 or 8 runs
    channels-last; a small launch keeps one chunk or run a segment."""
    cf = {s[1]: K7.plan(*s, K7.CHANNELS_FIRST, H100_SMS)["seg_len"] for s in STAGES}
    cl = {s[1]: K7.plan(*s, K7.CHANNELS_LAST, H100_SMS)["seg_len"] for s in STAGES}
    assert cf == {8000: 1024, 40000: 2048, 120000: 2048, 240000: 2048}
    assert cl == {8000: 32, 40000: 64, 120000: 64, 240000: 64}
    assert K7.plan(2, 700, 24, K7.CHANNELS_FIRST, H100_SMS)["seg_len"] == K7.CHUNK
    assert K7.plan(2, 700, 24, K7.CHANNELS_LAST, H100_SMS)["seg_len"] == K7.RUN
    assert not K7.plan(1, 130, 96, K7.CHANNELS_FIRST, H100_SMS)["vector"]
    with pytest.raises(ValueError):
        K7.plan(1, 8, 4, "channels_middle")


def test_aaact_hands_snake_aa_the_conv_memory(monkeypatch):
    """Every AAAct of a BigVGAN forward with use_kernel hands snake_aa the
    tensor it got, strides unchanged, and those are channels-first (the
    convolutions' and the residual sums' memory): no layout copy in front of
    K7, and y comes back in that layout."""
    cfg = tb.BigVGANConfig(vocab_size=30, input_size=16, output_size=16, mel_bin=8,
                           upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3),), speaker_embedding_dim=8,
                           use_pallas_act=True)
    torch.manual_seed(0)
    model = tb.BigVGAN(cfg).eval()
    seen, given = [], []
    real = tb.snake_aa

    def recording(x, alpha, beta, logscale):
        seen.append((x.data_ptr(), x.stride(), K7.memory_layout(x)))
        y = real(x, alpha, beta, logscale)
        assert y.stride() == x.stride()
        return y

    def hook(module, args):
        given.append((args[0].data_ptr(), args[0].stride()))

    monkeypatch.setattr(tb, "snake_aa", recording)
    acts = [m for m in model.modules() if isinstance(m, tb.AAAct)]
    for m in acts:
        m.register_forward_pre_hook(hook)
    token = torch.randint(0, cfg.vocab_size, (2, 12))
    wav, _ = model(token, torch.tensor([12, 7]), torch.randn(2, cfg.speaker_embedding_dim))
    assert len(seen) == len(acts) == len(cfg.upsample_rates) * 2 * 2 + 1
    assert [(p, s) for p, s, _ in seen] == given
    assert all(lay == K7.CHANNELS_FIRST for _, _, lay in seen)
    assert torch.isfinite(wav).all() and wav.shape == (2, 12 * 8)

