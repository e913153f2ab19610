"""Where the time of the port's calls goes on one NVIDIA H100.

    python3 chip_profile.py

Builds the kernels and the same in-memory 1.7B int8 models as chip_smoke.py
(random weights from its seed), then prints:
1. each kernel's registers, shared memory and spills, as ptxas reports them;
2. the host wall of the voice-clone call's parts (prompt creation, the
   prefill on the flash and on the dense route);
3. torch.profiler over one voice-clone call (bf16 and int8 KV), one
   custom-voice call, one int8-KV custom-voice stream and one int8-KV
   serving run (chip_smoke's 12 requests over 8 slots): device time by
   kernel (top rows) and the busy share (device kernel time over the
   unprofiled wall of the same call); each call's Chrome trace goes to
   build/traces/<call>/trace.json (`utils/profiling.py` `device_trace`).

A diagnostic beside the smoke; it checks nothing that chip_smoke.py does not.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

from chip_smoke import (CLONE_MAX_NEW_TOKENS, CLONE_REF_TEXT, CLONE_TEXTS, MAX_NEW_TOKENS,
                        SEED, SERVE_OVERRIDES, SERVE_REQUESTS, SERVE_SLOTS, TEXTS,
                        build_clone_model, build_model, line, model_params, phase_build,
                        phase_clone_front_end, phase_device, serve_all)
from qwen3_tts_tpu_torch.utils.profiling import device_trace

# one Chrome trace per profiled call (build/ is not committed)
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"


def phase_ptxas() -> None:
    """Registers, shared memory and spills of every kernel, as ptxas reports
    them for the sources the library is built from."""
    import re
    import tempfile

    from qwen3_tts_tpu_torch.ops.cuda import build

    for name in build.SOURCES:
        if not name.endswith(".cu"):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c", "-Xptxas", "-v",
                                   "-o", f"{tmp}/x.o", str(build.CSRC / name)],
                                  capture_output=True, text=True, check=True)
        kernel = None
        for row in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", row)
            if m:
                kernel = m.group(1)
            elif "spill" in row or "registers" in row:
                print(f"  [ptxas {name}] {kernel}: {row.split(':', 1)[-1].strip()}", flush=True)


def phase_profile(model, front, custom_voice_model) -> None:
    """Where the time of one call goes: host wall of the clone call's parts, then torch.profiler over one clone call and one
    custom-voice call: device time by kernel (top rows) and the busy share
    (device kernel time over the unprofiled wall of the same call)."""
    from qwen3_tts_tpu_torch.models.talker import KVCache, talker_prefill
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    def wall(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            out.append(round(time.time() - t0, 4))
        return out

    ref = (front["wav"], front["sr"])
    tc = model.config.talker_config
    with torch.no_grad():
        items = model.create_voice_clone_prompt(ref, ref_text=CLONE_REF_TEXT)
        specs, _ = model._specs_voice_clone(CLONE_TEXTS, "english", None, None, False,
                                            items, True)
        embeds, mask, _, _ = assemble_prompt_specs(model.talker_params, tc, model.config,
                                                   specs, bucket=32)

        def prefill(allow_flash):
            B, T = mask.shape
            cache = KVCache.zeros(tc.num_hidden_layers, B, T + CLONE_MAX_NEW_TOKENS + 1,
                                  tc.num_key_value_heads, tc.resolved_head_dim,
                                  device=embeds.device)
            talker_prefill(model.talker_params, tc, embeds, mask, cache,
                           allow_flash=allow_flash)

        line("profile clone parts",
             create_voice_clone_prompt_s=wall(lambda: model.create_voice_clone_prompt(
                 ref, ref_text=CLONE_REF_TEXT)),
             prefill_flash_s=wall(lambda: prefill(True)),
             prefill_dense_s=wall(lambda: prefill(False)))
    kw = dict(language="english", ref_audio=ref, ref_text=CLONE_REF_TEXT,
              non_streaming_mode=True, seed=SEED)
    from qwen3_tts_tpu_torch.runtime.server import TTSServer

    srv = TTSServer(custom_voice_model, num_slots=SERVE_SLOTS, overrides=SERVE_OVERRIDES,
                    max_new_tokens=MAX_NEW_TOKENS, seed=SEED)
    runs = iter(range(10**6))

    def serve():
        n = next(runs)
        serve_all(srv, [lambda i=i: srv.submit_custom_voice(
            f"{n}-{i}", text=f"{TEXTS[i % len(TEXTS)]} Request {i}.", speaker="vivian",
            language="english", stream=i % 2 == 0) for i in range(SERVE_REQUESTS)])

    calls = {
        "clone": lambda: model.generate_voice_clone(
            CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS, **kw),
        "clone int8_kv": lambda: model.generate_voice_clone(
            CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS, kv_quant=True, **kw),
        "custom_voice": lambda: custom_voice_model.generate_custom_voice(
            TEXTS, speaker="vivian", language="english", seed=SEED,
            max_new_tokens=MAX_NEW_TOKENS),
        "stream custom_voice int8_kv": lambda: list(custom_voice_model.stream_custom_voice(
            TEXTS, speaker="vivian", language="english", seed=SEED, kv_quant=True,
            max_new_tokens=MAX_NEW_TOKENS)),
        "serve custom_voice int8_kv": serve,
    }
    for name, fn in calls.items():
        walls = wall(fn, 2)
        # no `annotate` around the call: a record_function range comes back
        # among the CUDA events (a device-side annotation as long as the
        # call) and would count as kernel time
        with device_trace(str(TRACE_DIR / name.replace(" ", "_"))) as prof:
            fn()
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(e.name[:60], [0.0, 0])
                k[0] += e.device_time / 1e3
                k[1] += 1
        total = sum(t for t, _ in kernels.values())
        line(f"profile {name}", unprofiled_wall_s=walls, device_kernel_ms=f"{total:.1f}",
             busy_share=f"{total / 1e3 / min(walls):.3f}")
        for kname, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t:9.2f} ms {n:6d} launches  {kname}", flush=True)


def main() -> int:
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7

    phase_device()
    phase_build()
    phase_ptxas()
    device = torch.device("cuda")
    params = model_params(TALKER_1B7, device)
    model = build_model(params, TALKER_1B7, device)
    clone_model = build_clone_model(params, TALKER_1B7, device)
    front = phase_clone_front_end(clone_model)
    phase_profile(clone_model, front, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
