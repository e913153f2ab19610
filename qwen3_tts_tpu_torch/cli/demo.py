"""`qwen-tts-demo-torch` CLI, the port's web demo / HTTP serving front end
(counterpart of `qwen3_tts_tpu/cli/demo.py`, with the same flags):

    python -m qwen3_tts_tpu_torch CKPT_DIR [--quantize int8] [--warmup] [--port 8000] ...

It serves from one CUDA card (`--vocoder-device N` moves the engine's
vocoder to card N). When gradio is installed it launches Blocks
UIs per model kind (custom_voice / voice_design / base voice-clone with
prompt save/load); when it is not, a stdlib JSON-over-HTTP API with the same
three task modes, over `ThreadedTTSServer` (continuous batching, the frame
loop as CUDA graph replays):

    POST /tts {"task": "custom_voice"|"voice_design"|"voice_clone", ...}
      -> {"sample_rate": sr, "wavs_b64": [base64 16-bit PCM WAV, ...]}
    POST /tts_stream {...} -> chunked 16-bit little-endian PCM
    GET /healthz, GET /info
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
from typing import Any, Dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("qwen-tts-demo-torch",
                                description="Qwen3-TTS demo server (PyTorch + CUDA)")
    p.add_argument("checkpoint", type=str, help="model checkpoint directory")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8"],
                   help="weight-only quantization; int8 also routes the "
                        "sub-talker and the talker step onto the fused CUDA "
                        "kernels (fastest)")
    p.add_argument("--kv-quant", action="store_true",
                   help="store the talker KV cache as int8 (halves decode "
                        "attention HBM reads; wins at long generations)")
    p.add_argument("--no-fused-subtalker", action="store_true",
                   help="keep the plain PyTorch sub-talker even with "
                        "--quantize int8 (debugging / numerics A-B)")
    p.add_argument("--no-fused-talker-step", action="store_true",
                   help="keep the plain PyTorch talker decode step even "
                        "with --quantize int8 (debugging / numerics A-B)")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--share", action="store_true")
    p.add_argument("--concurrency", type=int, default=2)
    p.add_argument("--ssl-certfile", type=str, default=None)
    p.add_argument("--ssl-keyfile", type=str, default=None)
    # generation overrides (reference demo.py generation args)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--no-sample", action="store_true")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and capture the frame loop's "
                        "graphs of the standard shapes before serving")
    # engine serving (HTTP fallback server): concurrent requests share the
    # continuous-batching engine instead of serializing static generate calls
    p.add_argument("--no-engine", action="store_true",
                   help="serve HTTP requests through the static generate "
                        "path instead of the continuous-batching engine")
    p.add_argument("--num-slots", type=int, default=8,
                   help="engine decode slots (concurrent sequences)")
    p.add_argument("--prefill-bucket", type=int, default=128,
                   help="engine max prompt length (token positions)")
    p.add_argument("--vocoder-device", type=int, default=None,
                   help="CUDA device index to dedicate to the vocoder "
                        "(multi-card hosts: vocoding overlaps the talker "
                        "ticks of the serving card)")
    return p


def _detect_model_kind(model) -> str:
    return model.tts_model_type or "custom_voice"


def _gen_overrides(args) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if args.max_new_tokens is not None:
        out["max_new_tokens"] = args.max_new_tokens
    if args.top_k is not None:
        out["top_k"] = args.top_k
    if args.top_p is not None:
        out["top_p"] = args.top_p
    if args.temperature is not None:
        out["temperature"] = args.temperature
    if args.repetition_penalty is not None:
        out["repetition_penalty"] = args.repetition_penalty
    if args.no_sample:
        out["do_sample"] = False
    if args.kv_quant:
        out["kv_quant"] = True
    if args.no_fused_subtalker:
        out["fused_subtalker"] = False
    if args.no_fused_talker_step:
        out["fused_talker_step"] = False
    return out


def _wav_b64(wav, sr: int) -> str:
    import tempfile

    import numpy as np

    from ..utils.audio import write_wav

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        write_wav(f.name, np.asarray(wav), sr)
        f.seek(0)
        return base64.b64encode(open(f.name, "rb").read()).decode()


class _HttpDemo:
    """Stdlib HTTP fallback server.

    With `engine` set (a runtime.server.ThreadedTTSServer), /tts requests run
    concurrently through the continuous-batching engine and /tts_stream
    streams chunked 16-bit PCM per request. Without it, requests serialize
    through the static generate path under a semaphore."""

    def __init__(self, model, kind: str, overrides: Dict[str, Any],
                 concurrency: int = 2, engine=None):
        self.model = model
        self.kind = kind
        self.overrides = overrides
        self.lock = threading.Semaphore(concurrency)
        self.engine = engine

    def _engine_kwargs(self, task: str, payload: Dict[str, Any]
                       ) -> Dict[str, Any]:
        """Payload -> submit_<task> kwargs. Per-request sampling
        (temperature/top_p/repetition_penalty/do_sample, plus top_k up to
        the engine's candidate width) rides each slot; sub-talker sampling
        is per engine. max_new_tokens maps to the per-request frame
        budget."""
        keys = {
            "custom_voice": ("text", "speaker", "language", "instruct"),
            "voice_design": ("text", "instruct", "language"),
            "voice_clone": ("text", "language", "ref_audio", "ref_text",
                            "x_vector_only_mode"),
        }
        if task not in keys:
            raise ValueError(f"unknown task {task}")
        kw = {k: payload[k] for k in keys[task] if k in payload}
        for k in ("temperature", "top_p", "repetition_penalty", "do_sample",
                  "top_k"):
            if k in payload:
                kw[k] = payload[k]
        if "max_new_tokens" in payload:
            kw["max_frames"] = int(payload["max_new_tokens"]) - 1
        return kw

    def handle_stream(self, payload: Dict[str, Any]):
        """Generator of (pcm16 bytes, sample_rate) chunks via the engine."""
        if self.engine is None:
            raise ValueError("streaming requires engine serving "
                             "(run without --no-engine)")
        import numpy as np

        task = payload.get("task", self.kind)
        kw = self._engine_kwargs(task, payload)
        for pkt in self.engine.synthesize_stream(task, **kw):
            pcm = np.clip(pkt.wav, -1.0, 1.0)
            yield ((pcm * 32767.0).astype("<i2").tobytes(), pkt.sample_rate)

    def handle(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        task = payload.get("task", self.kind)
        if self.engine is not None:
            wav, sr = self.engine.synthesize(
                task, **self._engine_kwargs(task, payload))
            return {"sample_rate": sr, "wavs_b64": [_wav_b64(wav, sr)]}
        kwargs = dict(self.overrides)
        kwargs.update({k: payload[k] for k in
                       ("max_new_tokens", "top_k", "top_p", "temperature",
                        "repetition_penalty", "do_sample", "seed")
                       if k in payload})
        with self.lock:
            if task == "custom_voice":
                wavs, sr = self.model.generate_custom_voice(
                    text=payload["text"], speaker=payload["speaker"],
                    language=payload.get("language"),
                    instruct=payload.get("instruct"), **kwargs)
            elif task == "voice_design":
                wavs, sr = self.model.generate_voice_design(
                    text=payload["text"], instruct=payload["instruct"],
                    language=payload.get("language"), **kwargs)
            elif task == "voice_clone":
                ref_audio = payload.get("ref_audio")
                wavs, sr = self.model.generate_voice_clone(
                    text=payload["text"], language=payload.get("language"),
                    ref_audio=ref_audio, ref_text=payload.get("ref_text"),
                    x_vector_only_mode=payload.get("x_vector_only_mode", False),
                    **kwargs)
            else:
                raise ValueError(f"unknown task {task}")
        return {"sample_rate": sr,
                "wavs_b64": [_wav_b64(w, sr) for w in wavs]}

    def info(self) -> Dict[str, Any]:
        return {
            "model_type": self.model.tts_model_type,
            "model_size": self.model.tts_model_size,
            "tokenizer_type": self.model.tokenizer_type,
            "speakers": self.model.get_supported_speakers(),
            "languages": self.model.get_supported_languages(),
        }

    def serve(self, ip: str, port: int, ssl_certfile=None, ssl_keyfile=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        demo = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True})
                elif self.path == "/info":
                    self._json(200, demo.info())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/tts", "/tts_stream"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except Exception as e:
                    self._json(400, {"error": type(e).__name__,
                                     "detail": str(e)})
                    return
                if self.path == "/tts":
                    try:
                        self._json(200, demo.handle(payload))
                    except Exception as e:  # surfaced as the reference UI does
                        self._json(400, {"error": type(e).__name__,
                                         "detail": str(e)})
                    return
                # /tts_stream: chunked 16-bit little-endian PCM
                try:
                    gen = demo.handle_stream(payload)
                    first = next(gen, None)
                except Exception as e:
                    self._json(400, {"error": type(e).__name__,
                                     "detail": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/L16")
                sr = first[1] if first else 0
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    if data:
                        self.wfile.write(b"%x\r\n" % len(data))
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()

                try:
                    if first:
                        chunk(first[0])
                    for pcm, _ in gen:
                        chunk(pcm)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionError):
                    pass    # client went away mid-stream
                finally:
                    # a no-op when the stream completed; otherwise (a client
                    # disconnect or a mid-stream error) it cancels the
                    # request so the engine slot frees: the truncated
                    # chunked response is the client's error signal
                    gen.close()

            def log_message(self, fmt, *args):
                print(f"[qwen-tts-demo] {fmt % args}", file=sys.stderr)

        server = ThreadingHTTPServer((ip, port), Handler)
        if ssl_certfile:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_certfile, ssl_keyfile)
            server.socket = ctx.wrap_socket(server.socket, server_side=True)
        print(f"[qwen-tts-demo] serving {self.kind} on http://{ip}:{port}")
        self._server = server   # callers stop it with self._server.shutdown()
        try:
            server.serve_forever()
        finally:
            server.server_close()


def _launch_gradio(model, kind: str, overrides, args) -> None:
    import gradio as gr  # noqa: F401

    import numpy as np

    def tts_custom(text, speaker, language, instruct):
        wavs, sr = model.generate_custom_voice(
            text=text, speaker=speaker, language=language or None,
            instruct=instruct or None, **overrides)
        return (sr, np.asarray(wavs[0]))

    def tts_design(text, instruct, language):
        wavs, sr = model.generate_voice_design(
            text=text, instruct=instruct, language=language or None,
            **overrides)
        return (sr, np.asarray(wavs[0]))

    def tts_clone(text, ref_audio, ref_text, language, xvec_only):
        wavs, sr = model.generate_voice_clone(
            text=text, language=language or None, ref_audio=ref_audio,
            ref_text=ref_text or None, x_vector_only_mode=bool(xvec_only),
            **overrides)
        return (sr, np.asarray(wavs[0]))

    def save_prompt(ref_audio, ref_text, xvec_only):
        """Persist a reusable voice prompt as a reference-compatible .pt
        payload."""
        import os
        import tempfile

        from ..inference.model import save_voice_clone_prompts

        try:
            if ref_audio is None:
                return None, "Reference audio is required."
            if not xvec_only and not (ref_text or "").strip():
                return None, ("Reference text is required when x-vector-only "
                              "is not enabled.")
            items = model.create_voice_clone_prompt(
                ref_audio=ref_audio,
                ref_text=(ref_text or "").strip() or None,
                x_vector_only_mode=bool(xvec_only))
            fd, out = tempfile.mkstemp(prefix="voice_clone_prompt_",
                                       suffix=".pt")
            os.close(fd)
            save_voice_clone_prompts(out, items)
            return out, "Finished."
        except Exception as e:  # surfaced per request, as the reference UI does
            return None, f"{type(e).__name__}: {e}"

    def load_prompt_and_gen(file_obj, text, language):
        """Generate from a saved .pt/.npz voice prompt; accepts prompts made
        by the reference demo."""
        from ..inference.model import load_voice_clone_prompts

        try:
            if file_obj is None:
                return None, "Voice file is required."
            if not (text or "").strip():
                return None, "Target text is required."
            path = (getattr(file_obj, "name", None)
                    or getattr(file_obj, "path", None) or str(file_obj))
            items = load_voice_clone_prompts(path)
            wavs, sr = model.generate_voice_clone(
                text=text.strip(), language=language or None,
                voice_clone_prompt=items, **overrides)
            return (sr, np.asarray(wavs[0])), "Finished."
        except Exception as e:
            return None, f"{type(e).__name__}: {e}"

    with gr.Blocks(title="Qwen3-TTS (CUDA)") as demo:
        if kind == "custom_voice":
            text = gr.Textbox(label="Text")
            speaker = gr.Dropdown(model.get_supported_speakers(), label="Speaker")
            language = gr.Dropdown(model.get_supported_languages(),
                                   value="auto", label="Language")
            instruct = gr.Textbox(label="Instruction (optional)")
            audio = gr.Audio(label="Output")
            gr.Button("Generate").click(tts_custom,
                                        [text, speaker, language, instruct],
                                        audio)
        elif kind == "voice_design":
            text = gr.Textbox(label="Text")
            instruct = gr.Textbox(label="Voice description")
            language = gr.Dropdown(model.get_supported_languages(),
                                   value="auto", label="Language")
            audio = gr.Audio(label="Output")
            gr.Button("Generate").click(tts_design, [text, instruct, language],
                                        audio)
        else:
            text = gr.Textbox(label="Text")
            ref_audio = gr.Audio(label="Reference audio", type="filepath")
            ref_text = gr.Textbox(label="Reference transcript")
            language = gr.Dropdown(model.get_supported_languages(),
                                   value="auto", label="Language")
            xvec = gr.Checkbox(label="x-vector only")
            audio = gr.Audio(label="Output")
            gr.Button("Generate").click(
                tts_clone, [text, ref_audio, ref_text, language, xvec], audio)
            # voice-prompt save and load
            status = gr.Textbox(label="Status", interactive=False)
            prompt_file = gr.File(label="Voice prompt (.pt)")
            gr.Button("Save voice prompt").click(
                save_prompt, [ref_audio, ref_text, xvec],
                [prompt_file, status])
            load_file = gr.File(label="Load voice prompt")
            gr.Button("Generate from voice prompt").click(
                load_prompt_and_gen, [load_file, text, language],
                [audio, status])
    demo.queue(default_concurrency_limit=args.concurrency).launch(
        server_name=args.ip, server_port=args.port, share=args.share,
        ssl_certfile=args.ssl_certfile, ssl_keyfile=args.ssl_keyfile)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    vocoder_device = None
    if args.vocoder_device is not None:
        n = torch.cuda.device_count()
        if not 0 <= args.vocoder_device < n:
            parser.error(f"--vocoder-device {args.vocoder_device}: this host has {n} "
                         "CUDA device(s)")
        vocoder_device = torch.device("cuda", args.vocoder_device)
    from ..inference.model import Qwen3TTSModel

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = Qwen3TTSModel.from_pretrained(args.checkpoint, dtype=dtype,
                                          quantize=args.quantize)
    kind = _detect_model_kind(model)
    overrides = _gen_overrides(args)
    if args.warmup:
        from ..runtime.warmup import warmup_model

        secs = warmup_model(model, max_new_tokens=overrides.get("max_new_tokens"))
        print(f"[qwen-tts-demo] warmup finished in {secs:.1f}s")

    # only the availability probe may fall back: an ImportError raised
    # inside the UI's construction must surface
    try:
        import gradio  # noqa: F401
        have_gradio = True
    except ImportError:
        have_gradio = False
    if have_gradio:
        _launch_gradio(model, kind, overrides, args)
        return
    engine = None
    if not args.no_engine:
        from ..runtime.server import ThreadedTTSServer, TTSServer

        try:
            server = TTSServer(model, num_slots=args.num_slots,
                               prefill_bucket=args.prefill_bucket, overrides=overrides,
                               vocoder_device=vocoder_device)
        except Exception as e:
            print(f"[qwen-tts-demo] engine unavailable ({type(e).__name__}: {e}); "
                  "serving through the static generate path")
        else:
            if args.warmup:
                # the engine's graphs (serve ticks, staging prefill, vocoder)
                # are captured here, not under the first requests; on this
                # thread, before the loop thread takes the server over
                secs = server.warmup()
                print(f"[qwen-tts-demo] server warmup finished in {secs:.1f}s")
            engine = ThreadedTTSServer(server)
            print(f"[qwen-tts-demo] engine serving: {args.num_slots} slots")
    _HttpDemo(model, kind, overrides, args.concurrency, engine=engine).serve(
        args.ip, args.port, args.ssl_certfile, args.ssl_keyfile)


if __name__ == "__main__":
    main()
