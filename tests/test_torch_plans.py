"""The host-side launch plans of the port's two whole-layer kernels, K6
(`lm_step.plan`) and K4 (`dit_block.plan`), checked on the CPU: every
output column and input row of every phase covered exactly once, at most
one work item a block, and shared memory within a Hopper block's 227 KB.
Pure Python; the kernels themselves are held on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest

from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
from cosyvoice_tpu_torch.ops.kernels import lm_step as K6

SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use


def _covered_once(K, N, cols, splits, rows):
    """How often each (input row, output column) of a [K, N] GEMV is computed
    by the items (column tile, input-row split)."""
    seen = np.zeros((K, N), np.int32)
    for tile in range(N // cols):
        for split in range(splits):
            seen[split * rows:min((split + 1) * rows, K), tile * cols:(tile + 1) * cols] += 1
    return seen


@pytest.mark.parametrize("H,I,nq,nkv,C,sms", [
    (896, 4864, 14, 2, 384, 132),     # Qwen2-0.5B on an H100, the main path's cache
    (896, 4864, 14, 2, 4096, 132),    # a long cache: wider attention chunks
    (128, 256, 4, 2, 64, 8),          # a small shape on a small grid
], ids=["qwen2_0.5b", "qwen2_0.5b_long_cache", "small"])
def test_lm_step_plan_covers_each_phase_once(H, I, nq, nkv, C, sms):
    p = K6.plan(H, I, nq, nkv, C, sms)
    QKVW = (nq + 2 * nkv) * 64
    for name, K, N, nm in (("qkv", H, QKVW, 1), ("o", nq * 64, H, 1),
                           ("gate_up", H, I, 2), ("down", I, H, 1)):
        g = p[name]
        assert N % g["cols"] == 0 and g["cols"] % 16 == 0, name
        assert (_covered_once(K, N, g["cols"], g["splits"], g["rows"]) == 1).all(), name
        assert g["items"] == N // g["cols"] * g["splits"] <= p["blocks"] == sms, name
        assert g["item_bytes"] == nm * g["rows"] * g["cols"] <= p["region_bytes"][name], name
    att = p["attention"]
    keys = np.zeros(C, np.int32)
    for c in range(att["chunks"]):
        keys[c * att["chunk"]:(c + 1) * att["chunk"]] += 1
    assert (keys == 1).all() and att["items"] == nkv * att["chunks"] <= sms
    # the attention's region holds a chunk's bf16 K and V rows (64 values + 16
    # bytes each); every phase has a region of its own, all in one block
    assert att["item_bytes"] == 2 * att["chunk"] * (64 * 2 + 16) <= p["region_bytes"]["attention"]
    assert all(v % 16 == 0 for v in p["region_bytes"].values())
    assert sum(p["region_bytes"].values()) < p["smem_bytes"] <= SMEM_LIMIT


def test_lm_step_plan_at_qwen2_widths():
    """The plan at Qwen2-0.5B on 132 SMs, and its largest item of each phase
    against the even share of a layer's 14.91 MB of int8 weights."""
    p = K6.plan(896, 4864, 14, 2, 384, 132)
    got = {k: (p[k]["cols"], p[k]["items"] // p[k]["splits"], p[k]["splits"], p[k]["rows"])
           for k in ("qkv", "o", "gate_up", "down")}
    assert got == {"qkv": (64, 18, 7, 128), "o": (64, 14, 9, 100),
                   "gate_up": (128, 38, 3, 299), "down": (64, 14, 9, 541)}
    assert (p["attention"]["chunk"], p["attention"]["chunks"]) == (32, 12)
    assert K6.plan(896, 4864, 14, 2, 4096, 132)["attention"]["chunk"] == 64
    per_block = sum(p[k]["item_bytes"] for k in ("qkv", "o", "gate_up", "down"))
    layer = 896 * 1152 + 896 * 896 + 2 * 896 * 4864 + 4864 * 896
    assert layer / 132 < per_block < 1.15 * layer / 132
    # the largest region: gate+up's two [299, 128] int8 shares, the norm
    # weights and the o-proj's scales
    assert max(p["region_bytes"].values()) == p["region_bytes"]["gate_up"] == 76544 + 8 * 896
    assert p["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("B,T,dim,heads,ff", [(16, 640, 256, 8, 1024), (4, 600, 256, 8, 1024),
                                              (4, 256, 128, 2, 512)],
                         ids=["serving", "ragged_T", "small"])
def test_dit_block_plan_covers_rows_and_columns_once(B, T, dim, heads, ff):
    p = K4.plan(B, T, dim, heads, 64, ff)
    inner = heads * 64
    a, att, c = p["ln_qkv"], p["attention"], p["out_ffn"]
    for launch in (a, att, c):
        tiles = launch["grid"][0]
        rows = np.zeros(tiles * launch["rows"], np.int32)
        for t in range(tiles):
            rows[t * launch["rows"]:(t + 1) * launch["rows"]] += 1
        assert (rows[:T] == 1).all() and tiles * launch["rows"] - T < launch["rows"]
        assert launch["grid"][-1] == B and launch["smem"] <= SMEM_LIMIT
    cols = np.zeros(3 * inner, np.int32)
    for n in range(a["grid"][1]):
        cols[n * a["cols"]:(n + 1) * a["cols"]] += 1
    assert (cols == 1).all() and a["grid"][1] * a["cols"] == 3 * inner
    assert att["grid"][1] == heads
    # phase C holds x1, h2 (dim) and a 128-wide mid chunk of its 96 rows in
    # bf16 beside a two-slot ring of an o slab [96, 64] and a weight slab
    # [64, dim]; phase A fits three blocks an SM
    assert c["smem"] == 2 * (96 * (2 * (dim + 8) + 136) + 2 * (96 * 72 + 64 * (dim + 8)))
    assert 3 * a["smem"] <= 228 * 1024
