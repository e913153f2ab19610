"""The yardstick's counting rules: operations and bytes of the talker's
work and of each hand-written kernel's launch, against one NVIDIA H100's
published peaks.

Frozen copies of the repository's counting (the port's `utils/roofline.py`
FLOPs per frame, and the smoke run's kernel bounds `bound`,
`talker_step_bound`, the sub-talker's bound and `flash_work`), with the
peaks fixed to the data sheet: no environment variable moves them. Counting
rules: a matmul is 2*M*N*K; attention 4*heads*head_dim per query-key pair;
each input byte is read once and each output byte written once, whatever a
kernel reads again; elementwise work is not counted.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12        # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: Iterable[Tuple[float, float]] = ()) -> float:
    """The least time the card could take for work that moves `nbytes` and
    does `ops` ((count, peak rate) pairs): the larger of the two."""
    return max([nbytes / PEAK_BYTES_PER_S] + [n / rate for n, rate in ops])


def _dims(g: Dict[str, Any]):
    D = g["head_dim"]
    return (g["hidden_size"], g["intermediate_size"], g["num_attention_heads"] * D,
            g["num_key_value_heads"] * D)


def layer_weight_elems(g: Dict[str, Any]) -> int:
    """Matmul weight elements of one decoder layer (qkv, o, gate/up, down)."""
    H, I, nq, nkv = _dims(g)
    return H * (nq + 2 * nkv) + nq * H + 3 * H * I


def _layer_bytes_int8(g: Dict[str, Any]) -> int:
    """One int8 layer as the program holds it: the int8 matmuls, their fp32
    per-row scales, the bf16 norms (input, post-attention, q, k)."""
    H, I, nq, nkv = _dims(g)
    rows = (nq + 2 * nkv) + H + 2 * I + H
    return layer_weight_elems(g) + 4 * rows + 2 * (2 * H + 2 * g["head_dim"])


def talker_step_weight_bytes(cfg: Dict[str, Any]) -> int:
    """Kernel 2's weights: every int8 talker layer and the final norm."""
    t = cfg["talker"]
    return t["num_hidden_layers"] * _layer_bytes_int8(t) + 2 * t["hidden_size"]


def talker_step_launch(cfg: Dict[str, Any], rows: int, kv_slots: int,
                       kv_bytes: int = 4) -> float:
    """Bound (s) of one kernel-2 launch over `rows` rows that attend
    `kv_slots` valid KV slots in all (summed over rows): every layer weight
    byte once, each valid slot's K and V once (`kv_bytes` per element pair
    per (layer, slot, kv head) and head_dim: 2 * 2 bytes in bf16), each
    row's new slot written, the rows' hidden in and out; int8 products over
    every weight, fp32 attention over the valid slots."""
    t = cfg["talker"]
    L, Hkv, D, H = (t["num_hidden_layers"], t["num_key_value_heads"], t["head_dim"],
                    t["hidden_size"])
    nbytes = (talker_step_weight_bytes(cfg) + L * Hkv * D * kv_bytes * (kv_slots + rows)
              + 2 * rows * H * 2)
    ops = [(2 * rows * L * layer_weight_elems(t), PEAK_INT8_OPS),
           (4 * t["num_attention_heads"] * D * kv_slots * L, PEAK_FP32_FLOPS)]
    return bound_s(nbytes, ops)


def subtalker_launch(cfg: Dict[str, Any], rows: int) -> float:
    """Bound (s) of one kernel-1 launch over `rows` rows: every int8 layer
    byte, the bf16 lm heads and projection once, the gathered embedding
    rows, the sampling noise, the rows' inputs and codes; every one of the
    Q positions through every layer (int8), each step's lm head and the
    projection in bf16."""
    t, cp = cfg["talker"], cfg["code_predictor"]
    Q = t["num_code_groups"]
    Qm1, V, Hc, Ht = Q - 1, cp["vocab_size"], cp["hidden_size"], t["hidden_size"]
    proj = Hc != Ht
    nbytes = (cp["num_hidden_layers"] * _layer_bytes_int8(cp) + 2 * Hc
              + 2 * Qm1 * V * Hc + (2 * (Hc * Ht + Hc) if proj else 0)
              + Qm1 * rows * Ht * 2 + Qm1 * rows * V * 4 + 3 * rows * Ht * 2 + rows * Qm1 * 4)
    bf16 = 2 * rows * Qm1 * V * Hc + (2 * rows * Q * Hc * Ht if proj else 0)
    ops = [(2 * rows * Q * cp["num_hidden_layers"] * layer_weight_elems(cp), PEAK_INT8_OPS),
           (bf16, PEAK_BF16_FLOPS)]
    return bound_s(nbytes, ops)


def flash_work(T: int, starts: Sequence[int], window, Hq: int, Hkv: int, D: int):
    """(flops, bytes) a left-padded prefill's attention needs: the query-key
    pairs of the valid rows (each sees min(i - start + 1, window) keys),
    q/k/v of the valid tokens read once, the output written once (bf16)."""
    pairs = 0
    for s in starts:
        n = T - s
        w = window or n
        pairs += n * (n + 1) // 2 if n <= w else w * (w + 1) // 2 + (n - w) * w
    valid = sum(T - s for s in starts)
    return 4 * Hq * D * pairs, valid * (2 * Hq + 2 * Hkv) * D * 2


def frame_flops(cfg: Dict[str, Any], attend_len: int) -> int:
    """Matmul and attention FLOPs of one sequence advancing one frame: the
    talker step over `attend_len` slots with its codec head, and the whole
    sub-talker frame (Q positions, the projection, Q-1 lm heads)."""
    t, cp = cfg["talker"], cfg["code_predictor"]
    H, _, nq, _ = _dims(t)
    talker = (t["num_hidden_layers"] * (2 * layer_weight_elems(t) + 4 * nq * attend_len)
              + 2 * H * t["vocab_size"])
    Hc, _, nqc, _ = _dims(cp)
    Q = t["num_code_groups"]
    sub = Q * cp["num_hidden_layers"] * (2 * layer_weight_elems(cp) + 4 * nqc * (Q + 1))
    if Hc != H:
        sub += Q * 2 * H * Hc
    sub += (Q - 1) * 2 * Hc * cp["vocab_size"]
    return talker + sub


def prefill_flops(cfg: Dict[str, Any], T: int) -> int:
    """FLOPs of a prompt of T real tokens: every layer matmul per token,
    causal attention over the prompt, the codec head at the last token."""
    t = cfg["talker"]
    H, _, nq, _ = _dims(t)
    return (T * t["num_hidden_layers"] * 2 * layer_weight_elems(t)
            + t["num_hidden_layers"] * 4 * nq * T * (T + 1) // 2 + 2 * H * t["vocab_size"])


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) spans in seconds (the
    smoke run's `busy_share` arithmetic)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
