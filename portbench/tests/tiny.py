"""A tiny configuration and mix of the benchmark, for CPU tests: the real
harness, generator and readers over a two-layer talker."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny.cv_stream"


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "portbench/configs/qwen3-tts-12hz-1.7b.json").read_text())
    cfg["name"] = "tiny"
    cfg["talker"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                         text_hidden_size=64, num_code_groups=4)
    cfg["code_predictor"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                                 num_code_groups=4)
    cfg["vocoder"].update(codebook_dim=16, hidden_size=32, latent_dim=32, num_attention_heads=2,
                          num_key_value_heads=2, head_dim=16, intermediate_size=64,
                          num_hidden_layers=1, num_quantizers=4, decoder_dim=16)
    # the tiny configuration's own limits, from its CPU readings: the
    # program's gaps read about 0.003 (code 0) and 0.02 (sub-codes) standard
    # deviations, the int4 control's 0.3-0.7 and 0.5-1.3
    cfg["check_limits"] = {"code0_gap": 0.1, "subcode_gap": 0.2, "code0_topk_gap": 0.1,
                           "subcode_topk_gap": 0.2, "audio_err": 1e-4}
    return cfg


def tiny_mix() -> dict:
    mix = json.loads((ROOT / "portbench/traffic/cv_stream_c32.json").read_text())
    mix.update(clients=4, server=dict(mix["server"], num_slots=4, max_new_tokens=40,
                                      prefill_bucket=32),
               frames={"low": 5, "high": 30}, greedy_every=2,
               check_requests=2)
    return mix


def tiny_bench(tmp: Path) -> harness.Bench:
    """BENCHMARK.json's metrics and the real generators and readers, with
    the tiny configuration and mix added as files of their own under
    `tmp` (found by name, as a later PR's would be)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = tmp / spec["paths"][0]
    for sub in ("generators", "metrics", "tasks"):
        (home / sub).mkdir(parents=True, exist_ok=True)
        for f in (ROOT / "portbench" / sub).glob("*.py"):
            (home / sub / f.name).write_text(f.read_text())
    (home / "configs").mkdir(exist_ok=True)
    (home / "traffic").mkdir(exist_ok=True)
    (home / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (home / "traffic" / "tiny_mix.json").write_text(json.dumps(tiny_mix()))
    spec = copy.deepcopy(spec)
    spec["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                            "file": f"{spec['paths'][0]}/configs/tiny.json"})
    spec["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny_mix",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return harness.Bench(spec, tmp)


def run_tiny(tmp: Path, seed: int = 20260518, seconds: float = 2.0, trace: bool = False,
             control: bool = False) -> dict:
    torch.manual_seed(0)
    return harness.run(tiny_bench(tmp), CELL, seed, seconds, trace, "cpu",
                       time.perf_counter(), log=lambda s: None, control=control)
