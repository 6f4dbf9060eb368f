"""The port's ahead-of-time export (bin/export_aot.py), its K2-K4 operators
(torch.library, ops/kernels/) and the profiling module (utils/profiling.py),
on the CPU against the JAX package:
- the estimator of the JAX export test's small causal configuration
  (tests/test_config_tools.py) exported at T = 16, with the fused attention
  and norm off and on: the .pt2 file exists; the reloaded program equals
  the eager call at the export bar (rtol 1e-2, atol 1e-5) and the JAX
  estimator on the same weights at 2e-4 (PARITY.md's estimator bar); with
  the fused flags on, its graph calls cosyvoice.dit_attention_packed and
  cosyvoice.fused_layer_norm, and with fused_block at T = 128 cosyvoice.dit_block;
- the operators' fake implementations give the real outputs' shapes and dtypes;
- StageTimer.summary has the JAX one's keys and arithmetic; trace writes a
  Chrome trace file on the CPU."""
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from cosyvoice_tpu.models import flow as jflow
from cosyvoice_tpu.utils import profiling as jprof
from cosyvoice_tpu_torch import convert
from cosyvoice_tpu_torch.bin import export_aot
from cosyvoice_tpu_torch.models import flow as tflow
from cosyvoice_tpu_torch.ops.kernels import dit_block as K4
from cosyvoice_tpu_torch.utils import profiling as tprof

# tests/test_config_tools.py::test_export_aot_estimator's estimator
EST = dict(in_channels=32, out_channels=8, causal=True, channels=(16,), n_blocks=1,
           num_mid_blocks=1, num_heads=2, attention_head_dim=8)
T = 16


def _estimators(fused: bool):
    """(JAX estimator, its seeded params, the port estimator with them)."""
    flags = dict(fused_attention=fused, fused_norm=fused)
    jm = jflow.ConditionalDecoder(jflow.EstimatorConfig(**EST, **flags))
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    params = U.random_params(jm.init, U.KEY, z(2, T, 8), jnp.ones((2, T)), z(2, T, 8), z(2),
                             z(2, 8), z(2, T, 8), seed=7)
    tm = tflow.ConditionalDecoder(tflow.EstimatorConfig(**EST, **flags))
    tm.load_state_dict(convert.estimator_state_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_attention_norm"])
def test_export_estimator_matches_eager_and_jax(tmp_path, monkeypatch, fused):
    U.interpret_pallas(monkeypatch)
    jm, params, tm = _estimators(fused)
    flow = types.SimpleNamespace(decoder=types.SimpleNamespace(estimator=tm))
    report = export_aot.export_flow_estimator(flow, str(tmp_path), lengths=(T,))
    path = tmp_path / f"estimator_T{T}.pt2"
    assert path.exists() and report[T]["path"] == str(path)
    ops = report[T]["ops"]
    if fused:
        assert ops == {"dit_attention_packed": 3, "fused_layer_norm": 13}, ops
    else:
        assert ops == {}, ops
    # a prefix-contiguous pad mask (the fused route's contract) and seeded inputs
    rng = np.random.default_rng(8)
    x, mu, cond = (rng.standard_normal((2, T, 8)).astype(np.float32) for _ in range(3))
    mask = (np.arange(T)[None] < np.array([T, 11])[:, None]).astype(np.float32)
    args = (x, mask, mu, np.array([0.3, 0.8], np.float32),
            rng.standard_normal((2, 8)).astype(np.float32), cond)
    loaded = torch.export.load(str(path)).module()
    with torch.no_grad():
        got = loaded(*map(torch.from_numpy, args)).numpy()
        eager = tm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, eager, rtol=export_aot.RTOL, atol=export_aot.ATOL)
    want = np.asarray(jax.jit(jm.apply)(params, *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_export_fused_block_calls_the_block_operator(tmp_path):
    """The serving estimator with fused_block (2 x 64 heads, dim 128) at
    T = 128: the exported graph calls cosyvoice.dit_block once a DiT block,
    and the reloaded program equals eager at the export bar."""
    cfg = tflow.EstimatorConfig(in_channels=4 * U.N_MEL, out_channels=U.N_MEL, causal=True,
                                channels=(128,), n_blocks=1, num_mid_blocks=1, num_heads=2,
                                attention_head_dim=64, fused_attention=True, fused_norm=True,
                                approx_gelu=True, fused_block=True)
    torch.manual_seed(0)
    tm = tflow.ConditionalDecoder(cfg).eval()
    assert K4.supports(128, 2, 64, 128, 512)
    flow = types.SimpleNamespace(decoder=types.SimpleNamespace(estimator=tm))
    report = export_aot.export_flow_estimator(flow, str(tmp_path), lengths=(128,))
    assert report[128]["ops"] == {"dit_block": 3, "fused_layer_norm": 7}
    assert report[128]["max_abs_err"] <= 1e-5


def test_operator_fakes_match_real_outputs():
    """Each operator's fake implementation (the export trace's shapes) gives
    the shape and dtype of the CPU kernel's output."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    lens = torch.tensor([5, 3], dtype=torch.int32)
    w = K4.random_block_weights(128, 2, 64, 512, torch.float32, g, "cpu")
    calls = [
        lambda t: torch.ops.cosyvoice.dit_attention_packed(t(r(2, 5, 384)), t(lens), 0.125, 64),
        lambda t: torch.ops.cosyvoice.dit_attention(t(r(2, 5, 2, 64)), t(r(2, 5, 2, 64)),
                                                    t(r(2, 5, 2, 64)), t(lens), 0.125),
        lambda t: torch.ops.cosyvoice.fused_layer_norm(t(r(3, 4, 64).bfloat16()), t(r(64)),
                                                       t(r(64)), 1e-5, "mish"),
        lambda t: torch.ops.cosyvoice.dit_block(t(r(2, 5, 128)), t(lens), *map(t, w), 0.125,
                                                2, 64),
    ]
    with FakeTensorMode() as mode:
        fakes = [call(mode.from_tensor) for call in calls]
    for call, fake in zip(calls, fakes):
        real = call(lambda x: x)
        real, fake = (v if isinstance(v, tuple) else (v,) for v in (real, fake))
        assert [(tuple(a.shape), a.dtype) for a in fake] == \
            [(tuple(a.shape), a.dtype) for a in real]


def test_stage_timer_matches_jax():
    """The same stages timed by both packages' StageTimer: the same keys,
    calls and totals within 20 ms, and rtf = total / audio seconds."""
    jt, tt = jprof.StageTimer(), tprof.StageTimer()
    for name, secs in (("llm", 0.02), ("flow", 0.01), ("llm", 0.01)):
        with jt.stage(name), tt.stage(name):
            time.sleep(secs)
    for audio in (None, 2.0):
        want, got = jt.summary(audio), tt.summary(audio)
        assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
        for k in want:
            assert got[k]["calls"] == want[k]["calls"]
            assert abs(got[k]["total_s"] - want[k]["total_s"]) < 0.02
            if audio:
                assert got[k]["rtf"] == pytest.approx(got[k]["total_s"] / audio)
    assert tt.summary()["llm"]["calls"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(log_dir) on the CPU writes one Chrome trace file whose events
    include the traced op, and yields the profiler."""
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
