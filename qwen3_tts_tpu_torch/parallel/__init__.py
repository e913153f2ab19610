"""Data- and tensor-parallel execution over `torch.distributed`
(counterpart of `qwen3_tts_tpu/parallel/`)."""
