"""The port's roofline arithmetic (`qwen3_tts_tpu_torch/utils/roofline.py`)
against the JAX package's (`qwen3_tts_tpu/utils/roofline.py`): the same
counting rules give the same numbers for the same peaks and achievable
rate, at the tiny config of tests/test_roofline.py and at the 1.7B widths.
Only the defaults differ: the H100's peaks, and no achievable rate."""

import pytest
import torch

from qwen3_tts_tpu import config as jconfig
from qwen3_tts_tpu.utils import roofline as jroof
from qwen3_tts_tpu.utils.testing import TALKER_1B7 as J1B7
from qwen3_tts_tpu_torch import config as tconfig
from qwen3_tts_tpu_torch.utils import roofline as troof
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, random_talker_params,
                                               TALKER_1B7 as T1B7)
from qwen3_tts_tpu_torch.weights import quantize_talker_params

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

ENV = ("BENCH_PEAK_BF16_TFLOPS", "BENCH_PEAK_INT8_TOPS", "BENCH_HBM_GBPS",
       "BENCH_ACHIEVABLE_GBPS")


def _tiny(cfg_mod):
    return cfg_mod.TalkerConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, text_hidden_size=32, num_code_groups=3,
        code_predictor_config=cfg_mod.CodePredictorConfig(
            vocab_size=32, hidden_size=24, intermediate_size=40,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, num_code_groups=3))


CFGS = {"tiny": (_tiny(jconfig), _tiny(tconfig)), "1b7": (J1B7, T1B7)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weight_bytes,kv_bytes", [(1, 2), (1, 1), (2, 2)])
@pytest.mark.parametrize("which", ["tiny", "1b7"])
def test_decode_roofline_equals_jax(monkeypatch, which, weight_bytes, kv_bytes, fused):
    jcfg, tcfg = CFGS[which]
    jp = jroof.Peaks(bf16_flops=989e12, int8_ops=1979e12, hbm_bytes=3.35e12)
    tp = troof.Peaks(bf16_flops=989e12, int8_ops=1979e12, hbm_bytes=3.35e12)
    kw = dict(batch=4, attend_len=256, weight_bytes=weight_bytes, kv_bytes=kv_bytes,
              fused_subtalker=fused)
    monkeypatch.setenv("BENCH_ACHIEVABLE_GBPS", "2871.5")   # the JAX side's only input
    want = jroof.decode_roofline(jcfg, tick_seconds=4.5e-3, peaks=jp, **kw)
    monkeypatch.delenv("BENCH_ACHIEVABLE_GBPS")
    got = troof.decode_roofline(tcfg, tick_seconds=4.5e-3, peaks=tp,
                                achievable_gbps=2871.5, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    bkw = dict(weight_bytes=weight_bytes, kv_bytes=kv_bytes, fused_subtalker=fused)
    assert (troof.talker_bytes_per_tick(tcfg, 4, 256, **bkw)
            == jroof.talker_bytes_per_tick(jcfg, 4, 256, **bkw))
    for attend in (1, 256, 2432):
        assert (troof.talker_flops_per_frame(tcfg, attend)
                == jroof.talker_flops_per_frame(jcfg, attend))


def test_weight_bytes_match_the_ports_param_tree():
    cfg = CFGS["tiny"][1]
    p = quantize_talker_params(random_talker_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16))

    def layer_bytes(layers):
        return sum(layers[grp][nm]["weight"]["q"].nbytes
                   for grp, names in (("self_attn", ("qkv_proj", "o_proj")),
                                      ("mlp", ("gate_up_proj", "down_proj")))
                   for nm in names)

    actual = (layer_bytes(p["layers"]) + p["codec_head"]["q"].nbytes
              + layer_bytes(p["code_predictor"]["layers"])
              + p["code_predictor"]["lm_heads"].nbytes)
    assert troof.talker_bytes_per_tick(cfg, batch=4, attend_len=16)["weights"] == actual


def test_default_peaks_are_the_h100s_and_env_overrides(monkeypatch):
    assert troof.Peaks.from_env() == troof.Peaks(
        bf16_flops=989e12, int8_ops=1979e12, hbm_bytes=3350e9, fp32_flops=67e12)
    monkeypatch.setenv("BENCH_HBM_GBPS", "2000")
    monkeypatch.setenv("BENCH_PEAK_BF16_TFLOPS", "500")
    p = troof.Peaks.from_env()
    assert (p.hbm_bytes, p.bf16_flops, p.int8_ops) == (2000e9, 500e12, 1979e12)


def test_achievable_keys_none_without_a_rate_and_env_overrides(monkeypatch):
    cfg = CFGS["1b7"][1]
    kw = dict(batch=4, attend_len=256, tick_seconds=5e-3)
    r = troof.decode_roofline(cfg, **kw)
    assert r["achievable_floor_ms"] is None and r["pct_of_achievable_floor"] is None
    assert r["dma_floor_ms"] == pytest.approx(r["bytes_per_tick"] / 3350e9 * 1e3)
    at = troof.decode_roofline(cfg, achievable_gbps=3000.0, **kw)
    assert at["achievable_floor_ms"] == pytest.approx(at["bytes_per_tick"] / 3000e9 * 1e3)
    assert at["pct_of_achievable_floor"] == pytest.approx(at["achievable_floor_ms"] / 5.0)
    monkeypatch.setenv("BENCH_ACHIEVABLE_GBPS", "1500")
    env = troof.decode_roofline(cfg, achievable_gbps=3000.0, **kw)
    assert env["achievable_floor_ms"] == pytest.approx(2 * at["achievable_floor_ms"])
    # the same tick at another window moves only the KV terms
    wide = troof.decode_roofline(cfg, **dict(kw, attend_len=512))
    assert wide["kv_bytes_per_tick"] == pytest.approx(2 * r["kv_bytes_per_tick"])
    assert wide["weight_bytes_per_tick"] == r["weight_bytes_per_tick"]
