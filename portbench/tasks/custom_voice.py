"""The custom-voice task: a speaker of the configuration's table reads the
request's text (`TTSServer.submit_custom_voice`).

A task file gives what the harness and the check need of one task, found by
the `task` name of a traffic mix (`portbench/tasks/<task>.py`):

  build_model(cfg, seed, device)   the program's model for this task
  request_fields(rng, cfg)         (the submit call's task kwargs, the
                                   request record's task fields), drawn
                                   from the request's own generator
  submit(server, uid, kwargs)      the server's submit call
  prompt_tokens(req)               the request's real prompt tokens
                                   (the whole-step FLOP count)
  reference_prompt(cfg, ref, req)  the reference's prompt of a served
                                   request (`ReferenceTalker.prompt`, or
                                   `icl_prompt` for a voice clone)

and may give these, which custom voice leaves out (a task without one is
run and checked as this one is):

  submit(...) -> dict              what the program computed from the
                                   request's inputs during the call (a
                                   clone's encoded reference codes and
                                   speaker embedding): the check's record
                                   carries it as `served_inputs` (its
                                   tensors copied to the host after the
                                   window, for the sampled requests alone),
                                   and the reference takes it as its input
  context_frames(cfg, rec)         the (c, Q) reference frames that lead the
                                   request's stream ahead of its first
                                   generated frame, or None: the reference
                                   vocoder's context of the first packets
  CHECK_NAMES                      the task's own check numbers, compared
                                   after the five (`portbench/check.py`),
                                   each against `check_limits[name]` of the
                                   configuration (a run whose configuration
                                   lacks one fails at set-up)
  check_readings(cfg, seed,        {name: value} of those numbers over the
      device, tokens, audio,       sampled records (`control`: the task's
      control)                     own control's readings instead)
"""

from __future__ import annotations

from typing import Any, Dict

from portbench import system
from portbench.text import assistant_ids


def build_model(cfg: Dict[str, Any], seed: int, device):
    return system.build_model(cfg, "custom_voice", seed, device)


def request_fields(rng, cfg: Dict[str, Any]):
    """A speaker uniform over the configuration's table."""
    speakers = sorted(cfg["spk_id"])
    speaker = speakers[int(rng.integers(len(speakers)))]
    return {"speaker": speaker}, {"speaker": speaker}


def submit(server, uid: int, kwargs: Dict[str, Any]) -> None:
    server.submit_custom_voice(uid, **kwargs)


def prompt_tokens(req: Dict[str, Any]) -> int:
    """The role (3), the think block with its language (4, or 3 for auto),
    the speaker, pad and the first text token over codec_bos (the prompt
    layout of `runtime/prompts.py`)."""
    think = 3 if req.get("language") in (None, "auto") else 4
    return 3 + think + 2 + 1


def reference_prompt(cfg: Dict[str, Any], ref, req: Dict[str, Any]):
    lang = req.get("language")
    spk = cfg["spk_id"][req["speaker"]]
    return ref.prompt({
        "input_id": assistant_ids(req["words"]),
        "language_id": None if lang in (None, "auto") else cfg["codec_language_id"][lang],
        "speaker_embed": ref.tree["codec_embedding"][spk]})
