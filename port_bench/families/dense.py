"""The dense decoder family: the program's model config, the benchmark's
weights and the server that serves them.

The weights are the benchmark's, made on the device from the seed in a few
large draws, one per kind of matrix with every layer stacked, in the served
dtype: matrices N(0, 1/d_in), the embedding N(0, 1/d), the norms' scales
1 + N(0, 0.1^2), so that a fault in a scale shows.  The program gets views of
them in the layout its ``ContinuousServer(params=...)`` takes; the reference
(``reference/dense.py``) gets the same tensors, drawn again after the window.
"""
from __future__ import annotations

import torch

def shapes(config: dict) -> dict:
    """Each stacked weight's shape, (d_in, d_out) matrices as the program
    applies them (``x @ w``)."""
    L, d, f, v = (config[k] for k in ("num_hidden_layers", "hidden_size",
                                      "intermediate_size", "vocab_size"))
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // heads
    return {"embedding": (v, d), "unembed": (d, v), "norms": (L, 2, d), "final_norm": (d,),
            "wq": (L, d, heads * hd), "wk": (L, d, kv * hd), "wv": (L, d, kv * hd),
            "wo": (L, heads * hd, d), "wi": (L, d, f), "wu": (L, d, f), "wd": (L, f, d)}


def make_weights(config: dict, seed: int, device) -> dict:
    """The stacked weights, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    dt = getattr(torch, config["torch_dtype"])
    out = {}
    for name, shape in shapes(config).items():
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        if name in ("norms", "final_norm"):
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_((shape[-1] if name == "embedding" else shape[-2]) ** -0.5)
        out[name] = w
    return out


def program_config(config: dict, name: str):
    """The program's ``ModelConfig`` of the configuration file.  The program
    normalises with eps 1e-6, and runs no other activation or norm than the
    file states; a file that asks otherwise is refused."""
    from repro_torch.models.common import ModelConfig
    if config["rms_norm_eps"] != 1e-6 or config["hidden_act"] != "silu" \
            or config["tie_word_embeddings"] or config.get("attention_bias", False):
        raise ValueError(f"{name}: the port's dense family runs rmsnorm eps 1e-6, silu, "
                         "untied embeddings and no attention bias")
    d, heads = config["hidden_size"], config["num_attention_heads"]
    return ModelConfig(
        name=name, family="dense", num_layers=config["num_hidden_layers"], d_model=d,
        num_heads=heads, num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        head_dim=config.get("head_dim") or d // heads, rope_theta=float(config["rope_theta"]),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"])


def program_params(w: dict) -> dict:
    """The program's parameter tree, of views of the stacked weights."""
    layers = []
    for i in range(w["wq"].shape[0]):
        layers.append({
            "ln1": {"scale": w["norms"][i, 0]}, "ln2": {"scale": w["norms"][i, 1]},
            "attn": {k: {"w": w[k][i]} for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: {"w": w[k][i]} for k in ("wi", "wu", "wd")},
        })
    return {"embed": {"embedding": w["embedding"], "unembed": {"w": w["unembed"]}},
            "layers": layers, "final_norm": {"scale": w["final_norm"]}}


def make_server(config: dict, name: str, weights: dict, *, slots: int, max_seq: int,
                device):
    from repro_torch.serving.continuous import ContinuousServer
    return ContinuousServer(program_config(config, name), slots=slots, max_seq=max_seq,
                            params=program_params(weights), device=device)


def request(rid: int, prompt: list, n_new: int):
    from repro_torch.serving.continuous import Request
    return Request(rid, prompt, n_new)


def bucket(n: int) -> int:
    """The admission bucket the program pads a prompt of ``n`` tokens to."""
    from repro_torch.serving.engine import bucket_len
    return bucket_len(n)
