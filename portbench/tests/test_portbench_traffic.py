"""The traffic generator: a pure function of (seed, index), the stated
ranges, the same multiset of sizes for every seed."""

import json
from pathlib import Path

import numpy as np

from portbench.harness import _module
from portbench.text import assistant_ids, encode

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "portbench/traffic/cv_stream_c32.json").read_text())
CFG = json.loads((ROOT / "portbench/configs/qwen3-tts-12hz-1.7b.json").read_text())
TASK = _module(ROOT / "portbench/tasks/custom_voice.py")
GENERATOR = _module(ROOT / "portbench/generators/closed_loop.py")
BIG_SEED = 2 ** 31 + 12345


def Traffic(mix, seed, cfg):
    return GENERATOR.Traffic(mix, seed, cfg, TASK)


def test_deterministic_per_seed():
    a, b = Traffic(MIX, BIG_SEED, CFG), Traffic(MIX, BIG_SEED, CFG)
    for k in (0, 1, 7, 511, 900):
        ra, rb = a.request(k), b.request(k)
        assert ra["kwargs"] == rb["kwargs"] and ra["words"] == rb["words"]
    c = Traffic(MIX, BIG_SEED + 1, CFG)
    assert [a.request(k)["words"] for k in range(8)] != [c.request(k)["words"] for k in range(8)]


def test_ranges_and_shares():
    t = Traffic(MIX, 3, CFG)
    reqs = [t.request(k) for k in range(1024)]   # 32 whole blocks
    frames = np.array([r["max_frames"] for r in reqs])
    assert frames.min() >= 50 and frames.max() <= 125
    # log-uniform: the median near the geometric mean of the ends
    assert abs(np.median(frames) - np.sqrt(50 * 125)) < 3
    assert sum(r["greedy"] for r in reqs) == 1024 // MIX["greedy_every"]
    for r in reqs[:64]:
        assert len(r["words"]) == int(np.ceil(r["max_frames"] / MIX["frames_per_word"]))
        assert r["speaker"] in CFG["spk_id"] and r["kwargs"]["language"] == "english"
        assert r["kwargs"]["stream"] is True
        if r["greedy"]:
            assert r["kwargs"]["do_sample"] is False
            assert r["kwargs"]["subtalker_do_sample"] is False
    assert len({r["speaker"] for r in reqs}) == 9


def test_every_seed_has_the_same_sizes_in_every_block():
    n = MIX["clients"]
    for block in (0, 1, 9):
        sizes = [[Traffic(MIX, s, CFG).request(block * n + i)["max_frames"] for i in range(n)]
                 for s in (1, 2, BIG_SEED)]
        assert sorted(sizes[0]) == sorted(sizes[1]) == sorted(sizes[2])
        assert sizes[0] != sizes[1]


def test_word_tokenizer_keeps_the_template_layout():
    ids = assistant_ids([5, 77, 151642])
    assert ids[:3] == [151644, 77091, 198] and ids[3:6] == [5, 77, 151642]
    assert ids[-5:] == [151645, 198, 151644, 77091, 198]
    assert encode("w1 w2") == [1, 2]
