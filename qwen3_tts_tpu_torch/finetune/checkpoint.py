"""Training-state checkpoint and resume (counterpart of
`qwen3_tts_tpu/finetune/checkpoint.py`, which saves through orbax): the
params, the optimizer state and the step in one `torch.save` file per step
directory, `step_<8 digits>/state.pt`, the JAX package's layout and names.

A save writes into a temporary directory and renames it into place, so an
interrupted save leaves no `step_` directory that counts: a completed step
directory is 'step_' and digits only.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _is_step_dir(name: str) -> bool:
    return name.startswith("step_") and name[len("step_"):].isdigit()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_train_state(ckpt_dir: str, step: int, params, opt_state, keep: int = 3) -> None:
    """Save params (a tree of tensors), the optimizer state (e.g.
    `SFTOptimizer.state_dict()`) and the step; keep the newest `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state), "step": int(step)},
               os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    entries = sorted(d for d in os.listdir(ckpt_dir) if _is_step_dir(d))
    for stale in entries[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, stale), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(d for d in os.listdir(ckpt_dir) if _is_step_dir(d))
    if not entries:
        return None
    return int(entries[-1].split("_")[1])


def _like(tree, template):
    """Restored leaves onto the template leaves' devices and dtypes."""
    if isinstance(tree, dict):
        return {k: _like(v, template[k]) for k, v in tree.items()}
    if torch.is_tensor(tree) and torch.is_tensor(template):
        return tree.to(device=template.device, dtype=template.dtype)
    return tree


def restore_train_state(ckpt_dir: str, step: Optional[int] = None,
                        template: Optional[Dict[str, Any]] = None) -> Tuple[Any, Any, int]:
    """(params, opt_state, step) of `step` (default: the latest). With a
    `template` params tree, the params come back on its devices and dtypes;
    otherwise on the CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no train state under {ckpt_dir}")
    state = torch.load(os.path.join(ckpt_dir, f"step_{step:08d}", STATE_FILE),
                       map_location="cpu", weights_only=True)
    params = state["params"] if template is None else _like(state["params"], template)
    return params, state["opt_state"], int(state["step"])
