"""The whole serve step's share of the card's bf16 peak (989 TFLOP/s): the
talker's and the code predictor's FLOPs of every frame the window generated
and of every prompt it admitted (`roofline.frame_flops`,
`roofline.prefill_flops`), over the window. The vocoder's and the clone
front end's FLOPs are not counted."""

from portbench import roofline


def read(run):
    if run.busy_s is None:
        return None
    flops = (sum(roofline.frame_flops(run.config, kv + 1) for kv in run.frames)
             + sum(roofline.prefill_flops(run.config, T) for T in run.prompts))
    return 100.0 * flops / (run.window_s * roofline.PEAK_BF16_FLOPS)
