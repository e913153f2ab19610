"""Quality evaluation harness: reconstruction metrics, WER, speaker
similarity (counterpart of `qwen3_tts_tpu/evaluation.py`).

The reference publishes quality tables (Seed-TTS WER, speaker SIM,
tokenizer-reconstruction PESQ/STOI/UTMOS — README.md:465-1335) but ships no
evaluation code. This module provides the measurable pieces:

- signal metrics computable without external models: SNR, SI-SDR,
  log-spectral distance, mel-cepstral distortion (MCD), in numpy (the port's
  own copy: equal to the JAX package's on the same arrays);
- WER/CER with the usual text normalization, against any ASR callable
  (`asr_fn(wav, sr) -> str`), so Whisper or a cloud ASR plugs in where
  available;
- speaker similarity as cosine over the port's ECAPA speaker encoder
  (`models/speaker_encoder.py`), run on the device of its params.

The runner (`python -m qwen3_tts_tpu_torch.evaluation --device cuda ...`)
loads the port's `Qwen3TTSModel` / `Qwen3TTSTokenizer` in fp32 on
`--device`. Every optional asset (checkpoint, manifest, wav dir, Whisper
through `transformers`, the `pesq` and `pystoi` packages) is optional: a
missing one becomes a skip row with its reason. The UTMOS column stays in
the table, marked unavailable: no package provides its predictor, and a
score would need a model download.
"""

from __future__ import annotations

import os
import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Reconstruction / signal metrics
# ---------------------------------------------------------------------------


def _align(ref: np.ndarray, deg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = min(ref.shape[-1], deg.shape[-1])
    return ref[..., :n].astype(np.float64), deg[..., :n].astype(np.float64)


def snr_db(ref: np.ndarray, deg: np.ndarray) -> float:
    """Plain signal-to-noise ratio in dB."""
    ref, deg = _align(ref, deg)
    noise = ref - deg
    return float(10 * np.log10(
        (np.sum(ref ** 2) + 1e-12) / (np.sum(noise ** 2) + 1e-12)))


def si_sdr_db(ref: np.ndarray, deg: np.ndarray) -> float:
    """Scale-invariant SDR (Le Roux et al. 2019)."""
    ref, deg = _align(ref, deg)
    ref = ref - ref.mean()
    deg = deg - deg.mean()
    alpha = np.dot(deg, ref) / (np.dot(ref, ref) + 1e-12)
    target = alpha * ref
    noise = deg - target
    return float(10 * np.log10(
        (np.sum(target ** 2) + 1e-12) / (np.sum(noise ** 2) + 1e-12)))


def _stft_mag(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    if x.shape[-1] < n_fft:  # short signals: one zero-padded frame
        x = np.pad(x, (0, n_fft - x.shape[-1]))
    window = np.hanning(n_fft + 1)[:-1]
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    frames = np.stack([x[i * hop:i * hop + n_fft] * window
                       for i in range(n_frames)], axis=0)
    return np.abs(np.fft.rfft(frames, axis=-1))


def log_spectral_distance_db(ref: np.ndarray, deg: np.ndarray,
                             n_fft: int = 1024, hop: int = 256) -> float:
    """RMS distance between log power spectra, in dB."""
    ref, deg = _align(ref, deg)
    R = _stft_mag(ref, n_fft, hop)
    D = _stft_mag(deg, n_fft, hop)
    lr = 10 * np.log10(R ** 2 + 1e-10)
    ld = 10 * np.log10(D ** 2 + 1e-10)
    return float(np.mean(np.sqrt(np.mean((lr - ld) ** 2, axis=-1))))


def _mel_filter(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    # HTK-style mel filterbank (triangular, amplitude 1 peaks)
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0), hz_to_mel(sr / 2), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        for j in range(l, c):
            if c > l:
                fb[i, j] = (j - l) / (c - l)
        for j in range(c, r):
            if r > c:
                fb[i, j] = (r - j) / (r - c)
    return fb


def mcd_db(ref: np.ndarray, deg: np.ndarray, sr: int = 24000,
           n_fft: int = 1024, hop: int = 256, n_mels: int = 40,
           n_cep: int = 13) -> float:
    """Mel-cepstral distortion (dB), DCT of log-mel, c1..n_cep, standard
    10*sqrt(2)/ln(10) scaling."""
    ref, deg = _align(ref, deg)
    fb = _mel_filter(sr, n_fft, n_mels)
    def cep(x):
        m = np.log(fb @ _stft_mag(x, n_fft, hop).T ** 2 + 1e-10)  # (M, T)
        # DCT-II over mel axis
        M = m.shape[0]
        basis = np.cos(np.pi * np.arange(n_cep + 1)[:, None]
                       * (np.arange(M) + 0.5)[None, :] / M)
        return (basis @ m)[1:]  # drop c0 (energy)

    cr, cd = cep(ref), cep(deg)
    T = min(cr.shape[1], cd.shape[1])
    d = np.sqrt(np.sum((cr[:, :T] - cd[:, :T]) ** 2, axis=0))
    return float((10.0 * np.sqrt(2.0) / np.log(10.0)) * np.mean(d))


def reconstruction_report(ref: np.ndarray, deg: np.ndarray,
                          sr: int = 24000) -> Dict[str, float]:
    return {
        "snr_db": snr_db(ref, deg),
        "si_sdr_db": si_sdr_db(ref, deg),
        "lsd_db": log_spectral_distance_db(ref, deg),
        "mcd_db": mcd_db(ref, deg, sr=sr),
    }


# ---------------------------------------------------------------------------
# WER / CER
# ---------------------------------------------------------------------------


def normalize_text(text: str, lang: str = "en") -> str:
    """Whisper-style light normalization: casefold, strip punctuation,
    collapse whitespace; CJK splits into chars."""
    text = unicodedata.normalize("NFKC", text).casefold()
    text = re.sub(r"[^\w\s]|_", " ", text, flags=re.UNICODE)
    text = re.sub(r"\s+", " ", text).strip()
    return text


def _edit_distance(a: Sequence, b: Sequence) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str, lang: str = "en") -> float:
    """Word error rate (character error rate for zh/ja/ko/th)."""
    r, h = normalize_text(ref, lang), normalize_text(hyp, lang)
    if lang in ("zh", "ja", "ko", "th", "yue", "chinese", "japanese",
                "korean"):
        ru, hu = list(r.replace(" ", "")), list(h.replace(" ", ""))
    else:
        ru, hu = r.split(), h.split()
    if not ru:
        return 0.0 if not hu else 1.0
    return _edit_distance(ru, hu) / len(ru)


@dataclass
class WERResult:
    wer: float
    per_utterance: List[float]


def evaluate_wer(refs: Sequence[str], hyps: Sequence[str],
                 lang: str = "en") -> WERResult:
    per = [wer(r, h, lang) for r, h in zip(refs, hyps)]
    return WERResult(wer=float(np.mean(per)) if per else 0.0,
                     per_utterance=per)


# ---------------------------------------------------------------------------
# Speaker similarity
# ---------------------------------------------------------------------------


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.dot(a, b) /
                 (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def speaker_similarity_ecapa(speaker_encoder_params, speaker_encoder_cfg,
                             wav_a: np.ndarray, wav_b: np.ndarray) -> float:
    """Cosine similarity of ECAPA embeddings (both wavs 24 kHz mono) —
    the 12 Hz voice-clone speaker space — computed on the params' device
    in fp32."""
    import torch

    from .models.speaker_encoder import extract_speaker_embedding

    with torch.no_grad():
        ea, eb = (extract_speaker_embedding(
            speaker_encoder_params, speaker_encoder_cfg,
            torch.from_numpy(np.asarray(w, np.float32))).cpu().numpy() for w in (wav_a, wav_b))
    return cosine_similarity(ea, eb)


# ---------------------------------------------------------------------------
# Harnesses
# ---------------------------------------------------------------------------


def evaluate_tokenizer_roundtrip(tokenizer, wavs: Sequence[np.ndarray],
                                 sr: int) -> Dict[str, float]:
    """Encode+decode each wav through a Qwen3TTSTokenizer and aggregate
    reconstruction metrics (mean over utterances)."""
    reports: List[Dict[str, float]] = []
    for wav in wavs:
        enc = tokenizer.encode(np.asarray(wav, np.float32), sr=sr)
        out, out_sr = tokenizer.decode(enc)
        deg = np.asarray(out[0]).reshape(-1)
        ref = np.asarray(wav, np.float32).reshape(-1)
        if out_sr != sr:
            from .utils.audio import resample

            ref = resample(ref, sr, out_sr)
        reports.append(reconstruction_report(ref, deg, sr=out_sr))
    return {k: float(np.mean([r[k] for r in reports]))
            for k in reports[0]} if reports else {}


def evaluate_tts_wer(model, texts: Sequence[str],
                     asr_fn: Callable[[np.ndarray, int], str],
                     lang: str = "en", speaker: Optional[str] = None,
                     **generate_kwargs) -> WERResult:
    """Synthesize `texts`, transcribe with `asr_fn`, report WER.

    `asr_fn(wav, sr) -> str` is injectable (Whisper, a cloud API, or a test
    fake) — no ASR model ships in-image."""
    wavs, sr = model.generate_custom_voice(
        text=list(texts), speaker=speaker or
        model.get_supported_speakers()[0], **generate_kwargs)
    hyps = [asr_fn(np.asarray(w), sr) for w in wavs]
    return evaluate_wer(list(texts), hyps, lang=lang)


# ---------------------------------------------------------------------------
# One-command runner: checkpoint in -> BASELINE.md-shaped table out
# ---------------------------------------------------------------------------
#
# The reference publishes its quality tables (README.md:465-1335) but ships
# no evaluation code; this runner is the missing command.  Every external
# asset (checkpoint, eval manifest, ASR model, PESQ/STOI packages) is
# optional: a missing asset SKIPS its rows with the reason in the table
# instead of crashing, so the moment real checkpoints/datasets exist the
# parity claim is exactly one command:
#
#   python -m qwen3_tts_tpu_torch.evaluation --device cuda --ckpt CKPT_DIR \
#       --suite seed-tts --manifest seedtts_en.jsonl --asr-ckpt whisper-large-v3
#
# Manifest: JSONL, one utterance per line:
#   {"text": "...", "lang": "en",
#    "ref_audio": "path.wav", "ref_text": "..."}   # ref_* only for clone/SIM


def _try_pesq_stoi(ref: np.ndarray, deg: np.ndarray, sr: int
                   ) -> Dict[str, object]:
    """PESQ-WB/NB + STOI through their reference packages when installed;
    'unavailable' markers otherwise so the table shape matches BASELINE.md
    either way. UTMOS (BASELINE.md's fourth tokenizer column) needs the
    UTMOS22 predictor, which no installed package provides: its column is
    always marked."""
    out: Dict[str, object] = {}
    n = min(len(ref), len(deg))
    ref, deg = np.asarray(ref[:n], np.float64), np.asarray(deg[:n], np.float64)
    try:
        from pesq import pesq as _pesq  # type: ignore

        from .utils.audio import resample

        r16 = resample(ref.astype(np.float32), sr, 16000)
        d16 = resample(deg.astype(np.float32), sr, 16000)
        out["pesq_wb"] = float(_pesq(16000, r16, d16, "wb"))
        r8 = resample(ref.astype(np.float32), sr, 8000)
        d8 = resample(deg.astype(np.float32), sr, 8000)
        out["pesq_nb"] = float(_pesq(8000, r8, d8, "nb"))
    except ImportError:
        out["pesq_wb"] = out["pesq_nb"] = "unavailable (pesq not installed)"
    try:
        from pystoi import stoi as _stoi  # type: ignore

        out["stoi"] = float(_stoi(ref, deg, sr, extended=False))
    except ImportError:
        out["stoi"] = "unavailable (pystoi not installed)"
    out["utmos"] = "unavailable (utmos22 model not installed)"
    return out


def _load_manifest(path: str, max_items: int) -> List[Dict]:
    import json

    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
            if len(items) >= max_items:
                break
    return items


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    from .utils.audio import read_audio

    wav, sr = read_audio(path)
    return np.asarray(wav, np.float32).reshape(-1), sr


def _whisper_asr(asr_ckpt: str, lang: str):
    """ASR callable from a local/HF Whisper checkpoint via transformers;
    None (with a reason) when the model cannot be constructed."""
    try:
        import torch
        from transformers import (AutoModelForSpeechSeq2Seq, AutoProcessor)

        proc = AutoProcessor.from_pretrained(asr_ckpt)
        mdl = AutoModelForSpeechSeq2Seq.from_pretrained(asr_ckpt)
        mdl.eval()

        def asr(wav: np.ndarray, sr: int) -> str:
            from .utils.audio import resample

            if sr != 16000:
                wav = resample(np.asarray(wav, np.float32), sr, 16000)
            feats = proc(wav, sampling_rate=16000, return_tensors="pt")
            with torch.no_grad():
                ids = mdl.generate(feats.input_features, max_new_tokens=256)
            return proc.batch_decode(ids, skip_special_tokens=True)[0]

        return asr, None
    except Exception as e:  # model absent / wrong dir / no network
        return None, f"{type(e).__name__}: {e}"


def run_suite(args, processor=None, asr_fn=None) -> Dict[str, object]:
    """Execute the requested suites; every missing asset becomes a skip row.
    Models load in fp32 on `args.device`. `processor` stands in for the
    checkpoint's text tokenizer where that cannot load (`transformers`
    absent); `asr_fn(wav, sr) -> str` stands in for Whisper."""
    import torch

    report: Dict[str, object] = {"suites": {}, "skipped": {}}
    device = getattr(args, "device", "cuda")

    model = None
    tokenizer = None
    if args.ckpt:
        try:
            from .inference.model import Qwen3TTSModel

            model = Qwen3TTSModel.from_pretrained(args.ckpt, dtype=torch.float32,
                                                  device=device)
            if processor is not None:
                model.processor = processor
            tokenizer = model.speech_tokenizer
        except Exception as e:
            report["skipped"]["checkpoint"] = (
                f"cannot load {args.ckpt}: {type(e).__name__}: {e}")
    if tokenizer is None and args.tokenizer_ckpt:
        try:
            from .inference.tokenizer import Qwen3TTSTokenizer

            tokenizer = Qwen3TTSTokenizer.from_pretrained(
                args.tokenizer_ckpt, dtype=torch.float32, device=device)
        except Exception as e:
            report["skipped"]["tokenizer_checkpoint"] = (
                f"cannot load {args.tokenizer_ckpt}: {type(e).__name__}: {e}")

    suites = (["tokenizer", "seed-tts"] if args.suite == "all"
              else [args.suite])

    # -- tokenizer reconstruction (BASELINE.md PESQ/STOI table shape) ------
    if "tokenizer" in suites:
        key = "tokenizer_roundtrip"
        if tokenizer is None:
            report["skipped"][key] = ("no speech tokenizer: pass --ckpt or "
                                      "--tokenizer-ckpt")
        elif not args.wav_dir or not os.path.isdir(args.wav_dir):
            report["skipped"][key] = (
                f"eval wavs missing (--wav-dir {args.wav_dir!r}); point it "
                "at a directory of 24 kHz wavs")
        else:
            import glob

            paths = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav"))
                           )[:args.max_items]
            if not paths:
                report["skipped"][key] = f"no .wav files in {args.wav_dir}"
            else:
                rows = []
                for p in paths:
                    wav, sr = _read_wav(p)
                    enc = tokenizer.encode(wav, sr=sr)
                    out, out_sr = tokenizer.decode(enc)
                    deg = np.asarray(out[0]).reshape(-1)
                    ref = wav
                    if out_sr != sr:
                        from .utils.audio import resample

                        ref = resample(ref, sr, out_sr)
                    row = reconstruction_report(ref, deg, sr=out_sr)
                    row.update(_try_pesq_stoi(ref, deg, out_sr))
                    rows.append(row)
                agg = {}
                for k in rows[0]:
                    vals = [r[k] for r in rows if isinstance(r[k], float)]
                    agg[k] = (round(float(np.mean(vals)), 4) if vals
                              else rows[0][k])
                agg["n_utterances"] = len(rows)
                report["suites"][key] = agg

    # -- seed-tts-style synthesis eval (WER + speaker SIM) -----------------
    if "seed-tts" in suites:
        key = "seed_tts"
        if model is None:
            report["skipped"][key] = "no model: pass --ckpt"
        elif model.processor is None:
            report["skipped"][key] = (
                "checkpoint has no text tokenizer asset (AutoTokenizer "
                "failed to load): synthesis suites need one")
        elif not args.manifest or not os.path.exists(args.manifest):
            report["skipped"][key] = (
                f"eval manifest missing (--manifest {args.manifest!r}); "
                "JSONL of {text, lang[, ref_audio, ref_text]}")
        else:
            items = _load_manifest(args.manifest, args.max_items)
            asr, asr_skip = (None, "disabled (--asr none)")
            if asr_fn is not None:
                asr, asr_skip = asr_fn, None
            elif args.asr != "none":
                if args.asr_ckpt:
                    asr, asr_skip = _whisper_asr(args.asr_ckpt, args.lang)
                else:
                    asr_skip = "no --asr-ckpt given"
            wers, sims = [], []
            is_base = model.config.tts_model_type == "base"
            for it in items:
                text, lang = it["text"], it.get("lang", args.lang)
                ref_audio = it.get("ref_audio")
                if is_base and ref_audio and os.path.exists(ref_audio):
                    wavs, sr = model.generate_voice_clone(
                        text=text, language=None, ref_audio=ref_audio,
                        ref_text=it.get("ref_text"), max_new_tokens=args.max_new_tokens)
                else:
                    spk = args.speaker or model.get_supported_speakers()[0]
                    wavs, sr = model.generate_custom_voice(
                        text=text, speaker=spk,
                        max_new_tokens=args.max_new_tokens)
                wav = np.asarray(wavs[0]).reshape(-1)
                if asr is not None:
                    wers.append(wer(text, asr(wav, sr), lang=lang))
                if (ref_audio and os.path.exists(ref_audio)
                        and model.speaker_encoder_params is not None):
                    ref_wav, ref_sr = _read_wav(ref_audio)
                    if ref_sr != sr:
                        from .utils.audio import resample

                        ref_wav = resample(ref_wav, ref_sr, sr)
                    sims.append(speaker_similarity_ecapa(
                        model.speaker_encoder_params,
                        model.config.speaker_encoder_config,
                        ref_wav, wav))
            out: Dict[str, object] = {"n_utterances": len(items)}
            out["wer"] = (round(float(np.mean(wers)), 4) if wers
                          else f"unavailable ({asr_skip})")
            out["speaker_sim"] = (round(float(np.mean(sims)), 4) if sims
                                  else "unavailable (no ref_audio rows or "
                                       "no speaker encoder)")
            report["suites"][key] = out

    return report


def _format_table(report: Dict[str, object]) -> str:
    """BASELINE.md-shaped markdown table of whatever was measured/skipped."""
    lines = ["| suite | metric | value |", "|---|---|---|"]
    for suite, metrics in report["suites"].items():
        for k, v in metrics.items():
            lines.append(f"| {suite} | {k} | {v} |")
    for suite, reason in report["skipped"].items():
        lines.append(f"| {suite} | — | skipped: {reason} |")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None, processor=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.evaluation",
        description="Quality evaluation: checkpoint in -> BASELINE.md-shaped "
                    "table out.  Missing assets skip their rows (reason in "
                    "the table) instead of failing.")
    p.add_argument("--ckpt", help="model checkpoint dir (reference format)")
    p.add_argument("--tokenizer-ckpt",
                   help="speech-tokenizer checkpoint dir (tokenizer suite "
                        "without a full model)")
    p.add_argument("--suite", default="all",
                   choices=["all", "tokenizer", "seed-tts"])
    p.add_argument("--manifest",
                   help="JSONL eval set: {text, lang[, ref_audio, ref_text]}")
    p.add_argument("--wav-dir", help="directory of wavs (tokenizer suite)")
    p.add_argument("--asr", default="whisper", choices=["whisper", "none"])
    p.add_argument("--asr-ckpt", help="Whisper checkpoint for WER")
    p.add_argument("--lang", default="en")
    p.add_argument("--speaker", help="speaker for custom-voice synthesis")
    p.add_argument("--max-items", type=int, default=1000)
    p.add_argument("--max-new-tokens", type=int, default=2048)
    p.add_argument("--out", help="write the JSON report here")
    p.add_argument("--device", default="cuda",
                   help="where the models run (cuda, or cpu)")
    args = p.parse_args(argv)

    report = run_suite(args, processor=processor)
    print(_format_table(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"\nreport written to {args.out}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via main() tests
    import sys

    sys.exit(main())
