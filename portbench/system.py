"""The system under test: `qwen3_tts_tpu_torch` built from a configuration
file and the run's seed, and its `TTSServer` for a traffic mix.

The talker tree and the vocoder are the benchmark's draws
(`portbench/weights.py`); the program quantises the talker to int8 itself
(`quantize_talker_params`, what `from_pretrained(quantize="int8")` does)
and keeps its bf16 KV cache (its default). What differs by task (the model
type, the request, the prompt) is in `portbench/tasks/<task>.py`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import text, weights

COMPLETION_CHUNK_FRAMES = 64


def port_configs(cfg: Dict[str, Any], model_type: str):
    from qwen3_tts_tpu_torch.config import (CodecV2Config, CodecV2DecoderConfig, TalkerConfig,
                                            TTSModelConfig)

    talker = dict(cfg["talker"], code_predictor_config=cfg["code_predictor"],
                  spk_id=cfg.get("spk_id"), codec_language_id=cfg.get("codec_language_id"))
    tts = TTSModelConfig(
        talker_config=TalkerConfig.from_dict(talker),
        tts_model_type=model_type,
        tts_model_size=cfg["tts"]["tts_model_size"],
        **{k: v for k, v in cfg["tts"].items() if k.endswith("_token_id")})
    codec = CodecV2Config(decoder_config=CodecV2DecoderConfig.from_dict(cfg["vocoder"]))
    return tts, codec


def build_model(cfg: Dict[str, Any], model_type: str, seed: int, device):
    """The program's model of `model_type` (`TTSModelConfig.tts_model_type`)."""
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.weights import quantize_talker_params

    tts_cfg, codec_cfg = port_configs(cfg, model_type)
    params = quantize_talker_params(weights.talker_tree(cfg, seed, device))
    tok = Qwen3TTSTokenizer.from_params(codec_cfg,
                                        dec_params=weights.vocoder_tree(cfg, seed, device))
    # the completion decode's chunk (non-streamed requests only, which no
    # mix sends): `TTSServer.warmup` captures it at up to 16 rows, and at
    # the tokenizer's default of 300 frames those graphs alone overflow the
    # card beside a 32-slot server; 64 is the repository's smoke setting
    tok.chunk_size = COMPLETION_CHUNK_FRAMES
    return Qwen3TTSModel(tts_cfg, params, None, tok, text.WordTokenizer(), {},
                         quantized="int8", device=device)


def build_server(model, traffic: Dict[str, Any], seed: int, code_sink):
    from qwen3_tts_tpu_torch.runtime.server import TTSServer

    return TTSServer(model, seed=int(seed) % (2 ** 63), code_sink=code_sink,
                     **traffic["server"])


def graph_stats(device) -> Dict[str, int]:
    from qwen3_tts_tpu_torch.runtime import graphs

    return graphs.stats(device)


def free(device) -> None:
    """Drop every captured graph and cached block of the program."""
    import gc

    from qwen3_tts_tpu_torch.runtime import graphs

    graphs.clear(device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def trace_on(server) -> None:
    """The engine's per-request host timestamps (submit, staged,
    first_frame; the server adds first_packet), which
    `TTSServer.first_packet_trace` pops."""
    server.engine.trace_enabled = True


def counters(server) -> Dict[str, float]:
    return dict(server.metrics.snapshot()["counters"])

