"""Whole runs of the harness on the CPU over a tiny voice-clone cell whose
task, configuration and mix exist only as files added to a copy of the
bench: the task's served inputs, reference frames, own check number and the
reference's ICL prompt, each shown to fail on a planted fault; and the
custom-voice check as it was."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import vocoder as rv
from portbench.tests.tiny import run_tiny, tiny_bench, tiny_config, tiny_mix

import qwen3_tts_tpu_torch.runtime.prompts as prompts_mod
import qwen3_tts_tpu_torch.runtime.server as server_mod

CLONE = "tiny.clone_stream"
LEFT_CONTEXT = 25          # the server's default, which the tiny mix keeps

CLONE_TASK = '''"""Voice clone for CPU tests: the reference codes and the speaker
embedding are drawn from the request's generator in place of the encoders,
and reach `TTSServer.submit_voice_clone` as a prompt item."""

import numpy as np
import torch

from portbench import system
from portbench.text import ORDINARY_IDS, assistant_ids, ref_ids, words_text

CHECK_NAMES = ("ref_code_mismatch",)
REF_FRAMES = (8, 40)       # a reference's frames, uniform between the two
FRAMES_PER_WORD = 2        # reference frames a transcript word


def build_model(cfg, seed, device):
    return system.build_model(cfg, "base", seed, device)


def request_fields(rng, cfg):
    n = int(rng.integers(REF_FRAMES[0], REF_FRAMES[1] + 1))
    codes = rng.integers(0, cfg["vocoder"]["codebook_size"],
                         (n, cfg["talker"]["num_code_groups"]))
    ref_words = rng.integers(0, ORDINARY_IDS, max(1, n // FRAMES_PER_WORD)).tolist()
    spk = rng.normal(0.0, 0.02, cfg["talker"]["hidden_size"]).astype(np.float32)
    spk = torch.from_numpy(spk).to(torch.bfloat16).float().numpy()   # the table's dtype
    return ({"ref_code": codes, "ref_spk_embedding": spk, "ref_text": words_text(ref_words)},
            {"ref_code": codes, "ref_words": ref_words})


def _encode(codes):
    """The program's reference codes (where an encoder would run)."""
    return np.array(codes, copy=True)


def submit(server, uid, kwargs):
    from qwen3_tts_tpu_torch.inference.model import VoiceClonePromptItem

    kw = dict(kwargs)
    item = VoiceClonePromptItem(ref_code=_encode(kw.pop("ref_code")),
                                ref_spk_embedding=kw.pop("ref_spk_embedding"),
                                x_vector_only_mode=False, icl_mode=True,
                                ref_text=kw.pop("ref_text"))
    server.submit_voice_clone(uid, voice_clone_prompt=[item], **kw)
    return {"ref_code": torch.as_tensor(item.ref_code),
            "speaker_embed": torch.as_tensor(item.ref_spk_embedding)}


def prompt_tokens(req):
    think = 3 if req.get("language") in (None, "auto") else 4
    return 3 + think + 2 + len(req["ref_code"]) + 1


def reference_prompt(cfg, ref, req):
    lang, served = req.get("language"), req["served_inputs"]
    return ref.icl_prompt({
        "input_id": assistant_ids(req["words"]), "ref_id": ref_ids(req["ref_words"]),
        "ref_code": served["ref_code"], "speaker_embed": served["speaker_embed"],
        "language_id": None if lang in (None, "auto") else cfg["codec_language_id"][lang]})


def context_frames(cfg, rec):
    return rec["served_inputs"]["ref_code"]


def check_readings(cfg, seed, device, tokens, audio, control):
    """ref_code_mismatch: the share of the sampled requests' served
    reference codes that differ from the drawn ones (the control: the drawn
    codes over a codebook of half the entries)."""
    diff = total = 0
    for r in {r["index"]: r for r in tokens + audio}.values():
        want = np.asarray(r["ref_code"])
        got = want // 2 * 2 if control else np.asarray(r["served_inputs"]["ref_code"])
        total += want.size
        diff += int((got != want).sum()) if got.shape == want.shape else want.size
    return {"ref_code_mismatch": diff / max(total, 1)}
'''


def clone_config() -> dict:
    cfg = tiny_config()
    cfg["name"] = "tiny_base"
    cfg["check_limits"]["ref_code_mismatch"] = 0
    return cfg


def clone_mix() -> dict:
    mix = tiny_mix()
    mix.update(task="tiny_clone", server=dict(mix["server"], prefill_bucket=64))
    return mix


def clone_bench(tmp, task_src=CLONE_TASK, cfg=None):
    """The tiny bench with the clone cell's configuration, mix, task and a
    metric that sizes a staging launch from the mix, each a new file."""
    bench = tiny_bench(tmp)
    home = bench.home
    (home / "configs" / "tiny_base.json").write_text(json.dumps(cfg or clone_config()))
    (home / "traffic" / "tiny_clone_mix.json").write_text(json.dumps(clone_mix()))
    (home / "tasks" / "tiny_clone.py").write_text(task_src)
    (home / "metrics" / "staging_bucket.py").write_text(
        "def read(run):\n    return run.traffic['server']['prefill_bucket']\n")
    spec = bench.spec
    spec["configs"].append({"name": "tiny_base", "source": "test", "reduced": [], "why": "test",
                            "file": f"{spec['paths'][0]}/configs/tiny_base.json"})
    spec["workloads"].append({"name": CLONE, "config": "tiny_base", "traffic": "tiny_clone_mix",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "staging_bucket", "unit": "tokens", "better": "lower",
                              "source": "program_counter", "layer": "test", "moves": "setup_s",
                              "workloads": [CLONE]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and CLONE not in m["workloads"]:
            m["workloads"].append(CLONE)
    return bench


def run_clone(tmp, task_src=CLONE_TASK, trace=False, control=False, seconds=2.0):
    torch.manual_seed(0)
    return harness.run(clone_bench(tmp, task_src), CLONE, 20260611, seconds, trace, "cpu",
                       time.perf_counter(), log=lambda s: None, control=control)


def _recorded(monkeypatch):
    """rv.packet's calls ((history, start, count, ctx0)) and the check's
    samples, recorded."""
    calls, samples = [], []
    packet, sample = rv.packet, check.sample

    def recording_packet(voc, c, hist, start, count, ctx0, left_context):
        calls.append((hist.cpu().numpy().copy(), start, count, ctx0))
        return packet(voc, c, hist, start, count, ctx0, left_context)

    def recording_sample(*a, **kw):
        out = sample(*a, **kw)
        samples.append(out)
        return out
    monkeypatch.setattr(rv, "packet", recording_packet)
    monkeypatch.setattr(check, "sample", recording_sample)
    return calls, samples


def _packets_due(audio):
    return [(r, s, n) for r in audio for s, n, _ in r["packets"] if n]


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        calls, samples = _recorded(mp)
        res = run_clone(tmp_path_factory.mktemp("clone"), trace=True, control=True)
    return res, calls, samples


def test_the_mix_offers_both_icl_layouts_and_references_either_side_of_the_context(tmp_path):
    bench = clone_bench(tmp_path)
    mix, cfg = bench.traffic("tiny_clone_mix"), bench.config("tiny_base")
    gen = bench.generator(mix["generator"]).Traffic(mix, 5, cfg, bench.task("tiny_clone"))
    reqs = [gen.request(k) for k in range(64)]
    n_ref = [len(r["ref_code"]) for r in reqs]
    assert min(n_ref) < LEFT_CONTEXT < max(n_ref) and 8 <= min(n_ref) and max(n_ref) <= 40
    # ICL text (reference words, target words, tts_eos) against codec_bos + frames
    longer_text = [len(r["ref_words"]) + len(r["words"]) + 1 > len(r["ref_code"]) + 1
                   for r in reqs]
    assert any(longer_text) and not all(longer_text)


def test_clean_clone_run_is_correct_and_lists_the_tasks_number_last(clean):
    res, _, _ = clean
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0, res["check"]
    assert list(res["check"]) == list(check.NAMES) + ["ref_code_mismatch"]
    assert res["check"]["ref_code_mismatch"] == {"value": 0.0, "limit": 0}
    assert res["metrics"]["staging_bucket"]["value"] == 64
    json.dumps(res)


def test_clean_clone_run_vocodes_each_packet_after_its_reference_frames(clean):
    _, calls, samples = clean
    (tokens, audio), = samples
    due = _packets_due(audio) * 2           # the program's readings, then the control's
    assert len(calls) == len(due) > 0
    for (hist, start, count, ctx0), (r, s, n) in zip(calls, due):
        ref = np.asarray(r["served_inputs"]["ref_code"])
        assert (start, count, ctx0) == (s, n, len(ref))
        assert np.array_equal(hist, np.concatenate([ref, np.asarray(r["frames"])]))
    for r in tokens + audio:    # the served inputs reach the check on the host
        assert all(v.device.type == "cpu" for v in r["served_inputs"].values())


def test_control_fails_the_tasks_number(clean):
    res, _, _ = clean
    cfg = clone_config()
    assert res["control"]["ref_code_mismatch"] > cfg["check_limits"]["ref_code_mismatch"]
    assert res["control_correct"] is False


def _context_withheld(monkeypatch):
    monkeypatch.setattr(check, "_lead_frames", lambda task, cfg, rec: None)
    return CLONE_TASK


def _history_dropped(monkeypatch):
    orig = server_mod.TTSServer._submit_specs

    def no_history(self, request_id, specs, stream, ref_code, *a, **kw):
        return orig(self, request_id, specs, stream, None, *a, **kw)
    monkeypatch.setattr(server_mod.TTSServer, "_submit_specs", no_history)
    return CLONE_TASK


def _icl_over_zero_codes(monkeypatch):
    orig = prompts_mod._frame_codec_embed
    monkeypatch.setattr(prompts_mod, "_frame_codec_embed",
                        lambda params, cfg, codes: orig(params, cfg, torch.zeros_like(codes)))
    return CLONE_TASK


def _codes_altered(monkeypatch):
    src = CLONE_TASK.replace(
        "    return np.array(codes, copy=True)\n",
        "    out = np.array(codes, copy=True)\n    out[0, 0] = (out[0, 0] + 1) % 2048\n"
        "    return out\n")
    assert src != CLONE_TASK
    return src


@pytest.mark.parametrize("fault", [_context_withheld, _history_dropped, _icl_over_zero_codes,
                                   _codes_altered],
                         ids=["check_withholds_context_frames", "server_drops_clone_history",
                              "icl_over_zero_codes", "tasks_number_over_its_limit"])
def test_broken_clone_path_is_not_correct(fault, monkeypatch, tmp_path):
    res = run_clone(tmp_path, task_src=fault(monkeypatch))
    assert res["correct"] is False, res["check"]


def test_a_number_without_a_limit_fails_before_the_window(tmp_path):
    src = CLONE_TASK.replace('CHECK_NAMES = ("ref_code_mismatch",)',
                             'CHECK_NAMES = ("ref_code_mismatch", "speaker_gap")')
    seen = []
    with pytest.raises(KeyError, match="speaker_gap"):
        harness.run(clone_bench(tmp_path, src), CLONE, 7, 1.0, False, "cpu",
                    time.perf_counter(), log=seen.append)
    assert seen == []


def test_custom_voice_check_is_the_five_over_the_served_frames(monkeypatch, tmp_path):
    calls, samples = _recorded(monkeypatch)
    res = run_tiny(tmp_path, seconds=1.0)
    assert list(res["check"]) == list(check.NAMES) and res["correct"] is True, res["check"]
    (tokens, audio), = samples
    due = _packets_due(audio)
    assert len(calls) == len(due) > 0
    for (hist, start, count, ctx0), (r, s, n) in zip(calls, due):
        assert (start, count, ctx0) == (s, n, 0)
        assert np.array_equal(hist, np.asarray(r["frames"]))
    assert all(r["served_inputs"] is None for r in tokens + audio)
