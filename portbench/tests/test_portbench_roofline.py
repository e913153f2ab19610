"""The frozen counting rules against hand counts at the published widths."""

import json
from pathlib import Path

import pytest

from portbench import roofline

ROOT = Path(__file__).resolve().parents[2]


def cfg(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


@pytest.mark.parametrize("name,elems", [
    # per layer: qkv 2048 x (16+8+8)*128, o 2048 x 2048, gate/up/down 3 x 2048 x 6144
    ("qwen3-tts-12hz-1.7b", 28 * (2048 * 4096 + 2048 * 2048 + 3 * 2048 * 6144)),
    # per layer: qkv 1024 x 4096, o 2048 x 1024, gate/up/down 3 x 1024 x 3072
    ("qwen3-tts-12hz-0.6b", 28 * (1024 * 4096 + 2048 * 1024 + 3 * 1024 * 3072)),
])
def test_kernel2_int8_weights(name, elems):
    c = cfg(name)
    t = c["talker"]
    assert t["num_hidden_layers"] * roofline.layer_weight_elems(t) == elems
    gb = roofline.talker_step_weight_bytes(c) / 1e9
    assert gb == pytest.approx({"qwen3-tts-12hz-1.7b": 1.41, "qwen3-tts-12hz-0.6b": 0.44}[name],
                               abs=0.01)


def test_kernel2_bound_is_bytes_and_grows_with_kv():
    c = cfg("qwen3-tts-12hz-1.7b")
    w = roofline.talker_step_weight_bytes(c)
    b0 = roofline.talker_step_launch(c, 32, 0)
    assert b0 == pytest.approx((w + 28 * 8 * 128 * 4 * 32 + 2 * 32 * 2048 * 2)
                               / roofline.PEAK_BYTES_PER_S)
    # one more valid slot on one row: K and V of every layer and kv head in bf16
    d = roofline.talker_step_launch(c, 32, 1) - b0
    assert d == pytest.approx(28 * 8 * 128 * 2 * 2 / roofline.PEAK_BYTES_PER_S)


def test_kernel1_bound():
    c = cfg("qwen3-tts-12hz-1.7b")
    layer = 1024 * 4096 + 2048 * 1024 + 3 * 1024 * 3072
    assert roofline.layer_weight_elems(c["code_predictor"]) == layer
    b = roofline.subtalker_launch(c, 32)
    assert b >= 5 * layer / roofline.PEAK_BYTES_PER_S
    assert b >= 2 * 32 * 16 * 5 * layer / roofline.PEAK_INT8_OPS


def test_flash_work_hand_count():
    flops, nbytes = roofline.flash_work(4, [2, 0], None, 2, 1, 8)
    # rows of 2 and 4 valid tokens: 3 + 10 query-key pairs
    assert flops == 4 * 2 * 8 * 13
    assert nbytes == 6 * (2 * 2 + 2 * 1) * 8 * 2


def test_frame_flops_hand_count():
    c = cfg("qwen3-tts-12hz-0.6b")
    t, cp = c["talker"], c["code_predictor"]
    talker = 28 * (2 * roofline.layer_weight_elems(t) + 4 * 2048 * 10) + 2 * 1024 * 6400
    sub = 16 * 5 * (2 * roofline.layer_weight_elems(cp) + 4 * 2048 * 17) + 15 * 2 * 1024 * 2048
    assert roofline.frame_flops(c, 10) == talker + sub   # no projection at 0.6B


def test_union():
    assert roofline.union_s([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
