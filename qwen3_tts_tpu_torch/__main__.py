"""`python -m qwen3_tts_tpu_torch CKPT_DIR [--quantize int8] [--warmup] ...`:
the demo server of the port (cli/demo.py) on the card."""

from .cli.demo import main

if __name__ == "__main__":
    main()
