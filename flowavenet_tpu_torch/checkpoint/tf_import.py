"""Reference TF checkpoint importer (twin of
``flowavenet_tpu/checkpoint/tf_import.py``, on numpy alone).

Maps variables from a ryhorv/tf-flowavenet TF1 checkpoint onto our parameter
pytree so NLL parity can be validated against trained reference weights
(SURVEY §5.4: weight-norm ``kernel``/``wn/g``/``bias``, ActNorm ``b``/
``logs``, ZeroConv ``scale``, speaker embedding, upsampler kernels).

Reference variable scopes are deterministic
(model.py/modules.py variable_scope names):

    vocoder/FloWaveNet/Block_<i>/Flow_<j>/ActNorm/{b,logs}
    vocoder/FloWaveNet/Block_<i>/Flow_<j>/AffineCoupling/WaveNet/
        Conv_front/<keras>/{kernel,wn/g,bias}
        ResBlock_0_<n>/Conv_filter/<keras>/...   (k=3 dilated filter conv)
        ResBlock_0_<n>/Conv_gate/<keras>/...
        ResBlock_0_<n>/<keras>/...               (1x1s: filter_c, gate_c,
                                                  res, skip — disambiguated
                                                  by creation order + shape)
        Conv_final/<keras>/...
        ZeroConv1d/{<keras>/{kernel,bias}, scale}
    vocoder/FloWaveNet/conv2d_transpose[_k]/{kernel,wn/g,bias}
    vocoder/FloWaveNet/speaker_embeddings

``<keras>`` is an auto-numbered layer name (conv1d, conv1d_17, ...) that
depends on global creation order, so matching is done by scope prefix +
suffix kind + shape, with creation order (the trailing counter) breaking
ties among the 1x1 convs of a ResBlock.

``tools/dump_tf_checkpoint.py`` turns a TF checkpoint into the .npz this
module consumes (it keeps TF out of the runtime dependencies).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np

from ..config import ModelConfig
from ..utils.tree import tree_map


def _keras_index(name: str) -> int:
    """Creation-order index from an auto-numbered keras layer name."""
    m = re.search(r"(?:conv1d|conv2d_transpose)(?:_(\d+))?/", name)
    if not m:
        return -1
    return int(m.group(1)) if m.group(1) else 0


class _ScopeMatcher:
    def __init__(self, variables: Mapping[str, np.ndarray]):
        self.vars = dict(variables)
        self.used: set[str] = set()

    def take(self, prefix: str, suffix: str, shape=None) -> np.ndarray:
        """The unique unused var under ``prefix`` ending with ``suffix``
        (and matching ``shape`` if given); earliest keras index wins ties."""
        cands = [
            (name, arr) for name, arr in self.vars.items()
            if name.startswith(prefix) and name.endswith(suffix)
            and name not in self.used
            and (shape is None or tuple(arr.shape) == tuple(shape))
        ]
        if not cands:
            raise KeyError(
                f"no unused variable under {prefix!r} ending {suffix!r} "
                f"with shape {shape}")
        cands.sort(key=lambda kv: _keras_index(kv[0]))
        name, arr = cands[0]
        self.used.add(name)
        return np.asarray(arr)

    def take_wn_conv(self, prefix: str, shape) -> dict:
        v = self.take(prefix, "kernel", shape)
        g = self.take(prefix, "wn/g", (shape[-1],))
        b = self.take(prefix, "bias", (shape[-1],))
        return {"v": v, "g": g, "b": b}


def import_tf_checkpoint(variables: Mapping[str, np.ndarray],
                         cfg: ModelConfig,
                         scope: str = "vocoder/FloWaveNet") -> dict:
    """Build our params pytree from a {tf_var_name: array} mapping."""
    m = _ScopeMatcher({k: v for k, v in variables.items()
                       if k.startswith(scope) and "Adam" not in k
                       and "fp16" not in k})
    r = cfg.filter_size

    # upsampler: Conv2DTranspose kernels live directly under the model scope
    upsample = []
    for s in cfg.upsample_scales:
        shape = (2 * s, 3, 1, 1)
        upsample.append({
            "v": m.take(scope, "kernel", shape),
            "g": m.take(scope, "wn/g", (1,)),
            "b": m.take(scope, "bias", (1,)),
        })
    params: dict = {"upsample": upsample}

    if cfg.gin_channels > 0:
        params["speaker_emb"] = m.take(scope, "speaker_embeddings",
                                       (cfg.n_speakers, cfg.gin_channels))

    blocks = []
    in_ch, cin_ch = 1, cfg.num_mels
    gin = cfg.gin_channels if cfg.gin_channels > 0 else 0
    for i in range(cfg.n_block):
        sq, sq_c, sq_g = 2 * in_ch, 2 * cin_ch, 2 * gin
        out_ch = sq if cfg.affine else sq // 2
        flows = []
        for j in range(cfg.n_flow):
            fp = f"{scope}/Block_{i}/Flow_{j}/"
            actnorm = {
                "b": m.take(fp + "ActNorm", "/b", (1, 1, sq)),
                "logs": m.take(fp + "ActNorm", "/logs", (1, 1, sq)),
            }
            wp = fp + "AffineCoupling/WaveNet/"
            coupling = {
                "front": m.take_wn_conv(wp + "Conv_front", (3, sq // 2, r)),
                "layers": [],
                "final": m.take_wn_conv(wp + "Conv_final", (1, r, r)),
                "zero": {
                    "w": m.take(wp + "ZeroConv1d", "kernel", (1, r, out_ch)),
                    "b": m.take(wp + "ZeroConv1d", "bias", (out_ch,)),
                    "scale": m.take(wp + "ZeroConv1d", "scale",
                                    (1, 1, out_ch)).reshape(out_ch),
                },
            }
            for n in range(cfg.n_layer):
                rp = wp + f"ResBlock_0_{n}/"
                layer = {
                    "filter": m.take_wn_conv(rp + "Conv_filter", (3, r, r)),
                    "gate": m.take_wn_conv(rp + "Conv_gate", (3, r, r)),
                    # the four 1x1s are created in this order
                    # (modules.py:77-97): res, skip, filter_c, gate_c
                    "res": m.take_wn_conv(rp, (1, r, r)),
                    "skip": m.take_wn_conv(rp, (1, r, r)),
                    "filter_c": m.take_wn_conv(rp, (1, sq_c // 2, r)),
                    "gate_c": m.take_wn_conv(rp, (1, sq_c // 2, r)),
                }
                if gin > 0:
                    # modules.py:99-108, created after the c-convs; note the
                    # reference never calls them (g-drop bug) so trained
                    # checkpoints usually lack them — tolerate absence.
                    try:
                        layer["filter_g"] = m.take_wn_conv(rp,
                                                           (1, sq_g // 2, r))
                        layer["gate_g"] = m.take_wn_conv(rp,
                                                         (1, sq_g // 2, r))
                    except KeyError:
                        pass
                coupling["layers"].append(layer)
            flows.append({"actnorm": actnorm, "coupling": coupling})
        blocks.append({"flows": tree_map(
            lambda *xs: np.stack(xs).astype(np.float32), *flows)})
        in_ch, cin_ch, gin = in_ch * 2, cin_ch * 2, gin * 2
    params["blocks"] = blocks
    return tree_map(lambda x: np.asarray(x, np.float32), params)
