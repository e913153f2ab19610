"""Whole runs of the harness on the CPU at tiny widths: the result line's
keys, cells and tasks found by name from files added without an edit, the
check failing on broken timed paths, and the control failing its limits."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import check
from portbench.tests.tiny import CELL, ROOT, run_tiny, tiny_bench, tiny_config

import qwen3_tts_tpu_torch.ops.cuda.subtalker as subtalker_mod
import qwen3_tts_tpu_torch.runtime.batching as batching
import qwen3_tts_tpu_torch.runtime.server as server_mod


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    torch.set_num_threads(2)
    return run_tiny(tmp_path_factory.mktemp("clean"), trace=True, control=True)


def test_result_keys_and_check_last(clean):
    keys = list(clean)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check" and "breakdown" in keys
    assert set(clean["check"]) == set(check.NAMES)
    for row in clean["check"].values():
        assert set(row) == {"value", "limit"}
    assert clean["correct"] is True and clean["failed"] == 0 and clean["attempted"] > 0
    assert {"busy_s", "window_s", "count", "kind", "platform",
            "memory_peak_bytes"} <= set(clean["device"])
    json.dumps(clean)


def test_cell_config_mix_and_metric_found_by_name_from_new_files(tmp_path):
    bench = tiny_bench(tmp_path)
    (bench.home / "metrics" / "requests_in_window.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench.spec["end_to_end"].append({"name": "requests_in_window", "unit": "1",
                                     "better": "higher", "bound": 0.25,
                                     "source": "host_clock", "workloads": [CELL]})
    assert bench.config("tiny")["talker"]["hidden_size"] == 64
    assert bench.traffic(bench.cell(CELL)["traffic"])["clients"] == 4
    names = [m["name"] for m in bench.metrics(CELL, traced=False)]
    assert "requests_in_window" in names
    from portbench import harness
    import time
    res = harness.run(bench, CELL, 77, 1.0, False, "cpu", time.perf_counter(), log=lambda s: None)
    assert res["metrics"]["requests_in_window"]["value"] == res["attempted"]


def test_task_found_by_name_from_a_new_file(tmp_path):
    bench = tiny_bench(tmp_path)
    # a task that is custom voice with one speaker, added as a file of its own
    src = (bench.home / "tasks" / "custom_voice.py").read_text()
    (bench.home / "tasks" / "one_speaker.py").write_text(src.replace(
        "speakers = sorted(cfg[\"spk_id\"])", "speakers = [\"ryan\"]"))
    mix = bench.traffic("tiny_mix")
    (bench.home / "traffic" / "one_speaker_mix.json").write_text(
        json.dumps(dict(mix, task="one_speaker")))
    bench.spec["workloads"].append({"name": "tiny.one_speaker", "config": "tiny",
                                    "traffic": "one_speaker_mix", "chips": 1, "why": "test"})
    from portbench import harness
    import time
    seen = []
    res = harness.run(bench, "tiny.one_speaker", 78, 1.0, False, "cpu", time.perf_counter(),
                      log=seen.append)
    assert res["correct"] is True and res["attempted"] > 0, res["check"]
    gen = bench.generator(mix["generator"]).Traffic(mix, 78, bench.config("tiny"),
                                                    bench.task("one_speaker"))
    assert {gen.request(k)["speaker"] for k in range(16)} == {"ryan"}


def test_control_fails_a_limit(clean):
    ctl = check.verdict(tiny_config(), clean["control"], [{"greedy": True}, {"greedy": False}])
    assert not ctl["correct"]
    prog = {k: v["value"] for k, v in clean["check"].items()}
    for name in ("code0_gap", "subcode_gap", "code0_topk_gap", "subcode_topk_gap"):
        assert clean["control"][name] > prog[name], name


def _altered_tokens(monkeypatch):
    orig = batching.process_and_sample_rows

    def altered(*a, **kw):
        return (orig(*a, **kw) + 1) % 2048
    monkeypatch.setattr(batching, "process_and_sample_rows", altered)


def _stale_state(monkeypatch):
    orig = batching.serve_step

    def stale(params, cfg, state, *a, **kw):
        hidden = state.last_hidden
        out = orig(params, cfg, state, *a, **kw)
        state.last_hidden = hidden          # the step leaves its hidden state as it was
        return out
    monkeypatch.setattr(batching, "serve_step", stale)


def _code0_top_k_ignored(monkeypatch):
    orig = batching.process_and_sample_rows

    def full_vocabulary(logits, rows, top_k, *a, **kw):
        rows = rows.clone()
        rows[:, 4] = 0                      # every row keeps every candidate
        return orig(logits, rows, 0, *a, **kw)
    monkeypatch.setattr(batching, "process_and_sample_rows", full_vocabulary)


def _subcode_top_k_ignored(monkeypatch):
    orig = subtalker_mod.sampling_inputs

    def full_vocabulary(*a, **kw):
        do_sample, temp, kvec, gumbel = orig(*a, **kw)
        return do_sample, temp, torch.zeros_like(kvec), gumbel
    monkeypatch.setattr(subtalker_mod, "sampling_inputs", full_vocabulary)


def _altered_audio(monkeypatch):
    rows, first = server_mod._vocode_rows_compact, server_mod._first_packet_vocode
    monkeypatch.setattr(server_mod, "_vocode_rows_compact", lambda *a, **kw: rows(*a, **kw) * 0.5)

    def first_half(*a, **kw):
        wav, counts = first(*a, **kw)
        return wav * 0.5, counts
    monkeypatch.setattr(server_mod, "_first_packet_vocode", first_half)


@pytest.mark.parametrize("fault", [_altered_tokens, _stale_state, _code0_top_k_ignored,
                                   _subcode_top_k_ignored, _altered_audio],
                         ids=["token_altered", "state_unchanged", "code0_top_k_ignored",
                              "subcode_top_k_ignored", "audio_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = run_tiny(tmp_path)
    assert res["correct"] is False, res["check"]


def test_run_refuses_without_a_card(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "1.7b.cv_stream",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_imports_no_jax_and_reference_nothing_of_the_port():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "import portbench.check, portbench.reference.talker, portbench.reference.vocoder\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'qwen3_tts_tpu', 'qwen3_tts_tpu_torch'))\n"
            "assert not bad, bad\n"
            "from pathlib import Path; import tempfile\n"
            "from portbench.tests.tiny import run_tiny\n"
            "run_tiny(Path(tempfile.mkdtemp()), seconds=1.0)\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'qwen3_tts_tpu'})\n"
            "assert not bad, bad\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert p.returncode == 0, p.stderr[-2000:]
