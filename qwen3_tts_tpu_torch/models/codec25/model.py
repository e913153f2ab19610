"""The 25 Hz tokenizer's top-level model (counterpart of
`qwen3_tts_tpu/models/codec25/model.py`): encode (speech -> Whisper-VQ codes
+ CAM++ x-vector + reference mel) and decode (codes -> DiT mel -> BigVGAN
waveform), on the device of its parameters.

Rebuilds Qwen3TTSTokenizerV1Model (reference
modeling_qwen3_tts_tokenizer_v1.py:1360-1526) and the x-vector path
(vq/speech_vq.py:118-159). CAM++ runs in PyTorch from `campplus.onnx`'s
initializers; the kaldi fbank stays numpy on the host, as in the JAX
package, and its result goes to the device. There is no onnxruntime route.

Two of the JAX package's four compiled programs are graphs on a CUDA
device (`runtime/graphs.py`): the DiT sampler's step (`dit_sample`) and
CAM++ (`campplus_embed`). BigVGAN and the Whisper-VQ encode run eagerly:
their graphs would repay a capture only after tens of calls of one clip
length. Lengths are not bucketed, as in the JAX package: the DiT's
look-ahead makes end padding change the output.

Noise: the JAX package draws the sampler's noise from
`jax.random.PRNGKey(0)`, which torch cannot reproduce. `decode` takes
`noise=` ((B, T * repeats, mel_dim) fp32) or `generator=`; without either
it draws from a private generator seeded 0 on the model's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...config import CodecV1Config
from ...utils.kaldi import fbank as kaldi_fbank
from .bigvgan import bigvgan_forward
from .campplus import CAMPPlusConfig, campplus_embed, load_campplus_params
from .dit import dit_sample
from .encoder import quantize_speech, tokenizer_fp32
from .mel import bigvgan_ref_mel

Params = Dict[str, Any]


class XVectorExtractor:
    """CAM++ speaker vector plus the BigVGAN-style reference mel (reference
    vq/speech_vq.py:118-159). `path`: a campplus.onnx or .safetensors file,
    or None (then `extract_code` raises: pass precomputed x-vectors to
    decode)."""

    def __init__(self, path: Optional[str], device="cpu"):
        self.device = torch.device(device)
        self.cfg = CAMPPlusConfig()
        self.params = None if path is None else load_campplus_params(path, self.device)

    @staticmethod
    def _peak_norm(audio: np.ndarray, db_level: float = -6.0) -> np.ndarray:
        """sox `norm -6`: scale so the peak sits at -6 dBFS."""
        peak = np.abs(audio).max()
        if peak == 0:
            return audio
        target = 10.0 ** (db_level / 20.0)
        return (audio * (target / peak)).astype(np.float32)

    def extract_code(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """16 kHz waveform -> (xvector (D,), ref_mel (T, 80)), numpy fp32."""
        if self.params is None:
            raise RuntimeError("no CAM++ weights loaded (the checkpoint has no "
                               "campplus.onnx): pass precomputed `xvectors` to decode()")
        tokenizer_fp32()
        norm = self._peak_norm(np.asarray(audio, np.float32))
        with torch.no_grad():
            ref_mel = bigvgan_ref_mel(norm[None], device=self.device)[0].T.cpu().numpy()
            feat = kaldi_fbank(norm, num_mel_bins=self.cfg.feat_dim)
            feat = feat - feat.mean(axis=0, keepdims=True)
            emb = campplus_embed(self.params, self.cfg, torch.from_numpy(feat[None]))
        emb = emb.cpu().numpy().flatten()
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        return emb.astype(np.float32), ref_mel.astype(np.float32)


class CodecV1Model:
    def __init__(self, config: CodecV1Config, params: Params,
                 xvector_extractor: Optional[XVectorExtractor] = None):
        self.config = config
        self.params = params
        self.xvector_extractor = xvector_extractor
        self.device = params["decoder"]["dit"]["proj_out"]["weight"].device
        self._generator: Optional[torch.Generator] = None

    # -- metadata (reference 1381-1394) --------------------------------

    def get_model_type(self) -> str:
        return self.config.model_type

    def get_input_sample_rate(self) -> int:
        return self.config.input_sample_rate

    def get_output_sample_rate(self) -> int:
        return self.config.output_sample_rate

    def get_encode_downsample_rate(self) -> int:
        return self.config.encode_downsample_rate

    def get_decode_upsample_rate(self) -> int:
        return self.config.decode_upsample_rate

    # -- encode (reference 1444-1485) ----------------------------------

    def encode(self, wavs_16k: List[np.ndarray]):
        """16 kHz waveforms -> (codes, xvectors, ref_mels) lists."""
        codes, _ = quantize_speech(self.params["encoder"]["tokenizer"],
                                   self.config.encoder_config, wavs_16k)
        if self.xvector_extractor is None:
            raise RuntimeError("V1 encode needs an XVectorExtractor (campplus.onnx); "
                               "construct the model with xvector_extractor=...")
        xvectors, ref_mels = [], []
        for wav in wavs_16k:
            xv, rm = self.xvector_extractor.extract_code(np.asarray(wav))
            xvectors.append(xv)
            ref_mels.append(rm)
        return codes, xvectors, ref_mels

    # -- decode (reference 1487-1526) ----------------------------------

    def decode(self, audio_codes: np.ndarray, xvectors: np.ndarray, ref_mels: np.ndarray,
               num_steps: int = 10, guidance_scale: float = 0.5,
               sway_coefficient: float = -1.0, noise=None,
               generator: Optional[torch.Generator] = None) -> List[np.ndarray]:
        """audio_codes: (B, T) padded with -1; xvectors: (B, D); ref_mels:
        (B, Tr, mel). Returns each row's waveform trimmed to its codes."""
        tokenizer_fp32()
        codes = np.asarray(audio_codes)
        lengths = (codes > -1).sum(axis=1) * self.config.decode_upsample_rate
        codes = np.clip(codes, 0, None)
        dit_cfg = self.config.dit_config
        if codes.size and codes.max() >= dit_cfg.num_embeds:
            # the JAX package's gather fills NaN here (a silent NaN waveform);
            # on the card the gather would assert and end the CUDA context
            raise ValueError(f"code {int(codes.max())} is past the DiT's code table "
                             f"({dit_cfg.num_embeds} rows)")
        shape = (codes.shape[0], codes.shape[1] * dit_cfg.repeats, dit_cfg.mel_dim)
        if noise is None:
            if generator is None:
                if self._generator is None:
                    self._generator = torch.Generator(device=self.device)
                generator = self._generator.manual_seed(0)
            noise = torch.randn(shape, generator=generator, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
        dev = self.device
        with torch.no_grad():
            mel = dit_sample(self.params["decoder"]["dit"], dit_cfg,
                             torch.as_tensor(codes, device=dev),
                             torch.as_tensor(np.asarray(xvectors), dtype=torch.float32,
                                             device=dev),
                             torch.as_tensor(np.asarray(ref_mels), dtype=torch.float32,
                                             device=dev),
                             noise, num_steps=num_steps,
                             guidance_scale=float(guidance_scale),
                             sway_coefficient=float(sway_coefficient))
            wav = bigvgan_forward(self.params["decoder"]["bigvgan"],
                                  self.config.bigvgan_config, mel).cpu().numpy()
        return [wav[i, :lengths[i]] for i in range(wav.shape[0])]
