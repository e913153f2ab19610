"""Single-speaker SFT driver (counterpart of `qwen3_tts_tpu/finetune/sft.py`,
which rebuilds finetuning/sft_12hz.py):

    python -m qwen3_tts_tpu_torch.finetune.sft --init_model_path BASE \\
        --train_jsonl data.jsonl --output_model_path out [--device cuda]

- the base checkpoint loads in bf16 on `--device` (the card unless the
  caller passes `--device cpu`); one train step per full batch, gradient
  accumulation over `--grad_accum` steps (`finetune/train.py`); on the card
  with no mesh each step is one replay of a captured graph per (B, T,
  phase) (`make_train_step`), while the speaker encoder runs eagerly per
  batch, as the JAX package's `sft.py` runs it op by op;
- data and tensor parallel over `torch.distributed` (`parallel/mesh.py`):

      torchrun --nproc_per_node N -m qwen3_tts_tpu_torch.finetune.sft ... \
          --dp a --tp b [--backend gloo]

  `--dp * --tp` must equal the world size (1 without a launcher), or it
  raises. Each rank trains its tensor-parallel shards on its
  `batch_size / dp` rows of every batch (dp must divide the batch); the
  gradients are summed over dp (`make_train_step`). The speaker embedding
  kept is row 0 of the whole batch, which dp rank 0 computes and
  broadcasts. Rank 0 gathers the shards back into the unsharded layout and
  alone writes each epoch's checkpoint; the others wait at a barrier.
  `--backend` names the process groups' backend (default NCCL on `cuda`,
  gloo on `cpu`); ranks that share one card pass gloo;
- the per-epoch save mirrors the reference (sft_12hz.py:126-158): copy the
  base directory to `checkpoint-epoch-N`, drop sharded-checkpoint remnants,
  rewrite config.json to custom_voice with spk_id {name: row}, write the
  learned speaker embedding into codec_embedding row `--speaker_row`, and
  save the talker (fp32) as model.safetensors.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def main(argv=None, processor=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--init_model_path", type=str, required=True)
    parser.add_argument("--output_model_path", type=str, default="output")
    parser.add_argument("--train_jsonl", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--num_epochs", type=int, default=3)
    parser.add_argument("--speaker_name", type=str, default="speaker_test")
    parser.add_argument("--speaker_row", type=int, default=3000,
                        help="codec_embedding row that stores the learned "
                             "speaker (reference uses 3000)")
    parser.add_argument("--grad_accum", type=int, default=4)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--backend", type=str, default=None)
    args = parser.parse_args(argv)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if args.dp * args.tp != world:
        raise ValueError(f"--dp {args.dp} x --tp {args.tp} must equal the world size "
                         f"{world} (launch with torchrun --nproc_per_node "
                         f"{args.dp * args.tp})")
    if args.batch_size % args.dp:
        raise ValueError(f"--dp {args.dp} must divide --batch_size {args.batch_size}")

    from ..inference.model import Qwen3TTSModel
    from ..models.speaker_encoder import speaker_encoder_forward
    from ..parallel.mesh import make_mesh, shard_talker_params, tp_shard_plan, \
        unshard_talker_params
    from .data import TTSDataset
    from .train import default_optimizer, make_train_step, param_flags, trainable

    mesh = (make_mesh(args.dp, args.tp, device=args.device, backend=args.backend)
            if world > 1 else None)
    rank0 = mesh is None or dist.get_rank() == 0
    model = Qwen3TTSModel.from_pretrained(args.init_model_path, dtype=torch.bfloat16,
                                          device=args.device if mesh is None else mesh.device)
    if processor is not None:
        model.processor = processor
    cfg = model.config
    tc = cfg.talker_config
    device = model.device

    with open(args.train_jsonl) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    dataset = TTSDataset(rows, model._tokenize, cfg, num_code_groups=tc.num_code_groups)

    plan = sharded = None
    if mesh is not None:
        plan = tp_shard_plan(model.talker_params, mesh)
        sharded = param_flags(model.talker_params, plan)
        model.talker_params = shard_talker_params(model.talker_params, mesh, plan)
    params = trainable(model.talker_params)
    model.talker_params = None          # the trainable copy replaces the load
    optimizer = default_optimizer(params, lr=args.lr, grad_accum=args.grad_accum,
                                  mesh=mesh, sharded=sharded)
    train_step = make_train_step(tc, optimizer)
    rows = slice(None) if mesh is None else mesh.rows(args.batch_size)

    target_speaker_embedding: Optional[torch.Tensor] = None
    rng = np.random.default_rng(args.seed)
    order = np.arange(len(dataset))

    for epoch in range(args.num_epochs):
        rng.shuffle(order)
        for start in range(0, len(order) - args.batch_size + 1, args.batch_size):
            idxs = order[start:start + args.batch_size]
            # the whole batch is collated (its padding is the whole batch's),
            # then this dp rank keeps its rows
            batch = {k: v[rows] for k, v in dataset.collate(
                [dataset[i] for i in idxs], pad_to_multiple=64).items()}
            ref_mels = torch.as_tensor(batch.pop("ref_mels"), device=device).to(torch.bfloat16)
            with torch.no_grad():   # stop_gradient in the JAX driver
                spk = speaker_encoder_forward(model.speaker_encoder_params,
                                              cfg.speaker_encoder_config, ref_mels)
            if target_speaker_embedding is None:
                target_speaker_embedding = spk[0].detach().float()
                if mesh is not None:   # the whole batch's row 0: dp rank 0's
                    dist.broadcast(target_speaker_embedding, src=0)
                target_speaker_embedding = target_speaker_embedding.cpu()
            tbatch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            metrics = train_step(params, tbatch, spk)
            step = start // args.batch_size
            if step % 10 == 0 and rank0:
                print(f"Epoch {epoch} | Step {step} | Loss: {float(metrics['loss']):.4f}")

        if target_speaker_embedding is None:
            raise ValueError(
                f"no training step ran: dataset has {len(dataset)} rows, "
                f"batch_size={args.batch_size} (full batches only, matching "
                "the reference loop) — reduce batch_size or add data")
        whole = params if mesh is None else unshard_talker_params(params, plan, mesh)
        if rank0:
            _save_epoch(args, epoch, whole, tc, target_speaker_embedding)
        if mesh is not None:
            dist.barrier()


def _save_epoch(args, epoch: int, params, tc, speaker: torch.Tensor) -> None:
    """The per-epoch checkpoint (reference sft_12hz.py:126-158): unsharded
    params, the learned speaker row."""
    from ..weights import save_safetensors, talker_params_to_state_dict

    out_dir = os.path.join(args.output_model_path, f"checkpoint-epoch-{epoch}")
    shutil.copytree(args.init_model_path, out_dir, dirs_exist_ok=True)
    # sharded remnants of the base would shadow the model.safetensors
    # written below (load_safetensors_dir prefers the index file)
    for stale in ([os.path.join(out_dir, "model.safetensors.index.json")]
                  + glob.glob(os.path.join(out_dir, "model-*-of-*.safetensors"))):
        if os.path.exists(stale):
            os.remove(stale)
    with open(os.path.join(args.init_model_path, "config.json")) as f:
        config_dict = json.load(f)
    config_dict["tts_model_type"] = "custom_voice"
    talker_cfg = config_dict.get("talker_config", {})
    talker_cfg["spk_id"] = {args.speaker_name: args.speaker_row}
    talker_cfg["spk_is_dialect"] = {args.speaker_name: False}
    config_dict["talker_config"] = talker_cfg
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config_dict, f, indent=2, ensure_ascii=False)

    sd = talker_params_to_state_dict(params, tc)
    emb = sd["talker.model.codec_embedding.weight"].clone()
    emb[args.speaker_row] = speaker.to(emb.dtype)
    sd["talker.model.codec_embedding.weight"] = emb
    save_safetensors(os.path.join(out_dir, "model.safetensors"),
                     {k: v.to(torch.float32) for k, v in sd.items()})
    print(f"saved {out_dir}")


if __name__ == "__main__":
    main()
