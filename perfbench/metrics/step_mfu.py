"""The whole step's share of the card's peak: the model FLOPs of the
tokens that the traced run's unprofiled window completed, over that
window's wall time × 989 TFLOP/s (the H100 SXM's dense bf16 peak,
published; the card's power limit is logged beside it).

Model FLOPs, counted from the configuration's published sizes alone: 6 ×
the parameters a token passes through in matrix products (query, key,
value and output projections, the MLP's three or the top-k experts'
three each, the router, the LM head; the embedding is a gather and not
counted) per token, plus causal attention, 6·S²·H·D a sequence and layer
(forward QKᵀ and PV at half the S² pairs, the backward twice that), with
H the published query heads. Neither the recompute of remat nor any
per-example-norm work is counted, so both show as lost MFU."""
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "Step"
MOVES = "tokens_per_s"

PEAK_BF16 = 989e12


def matmul_params_per_token(c):
    d, f = c["hidden_size"], c["intermediate_size"]
    hq = c["num_attention_heads"] * c["head_dim"]
    hkv = c["num_key_value_heads"] * c["head_dim"]
    attn = d * hq + 2 * d * hkv + hq * d
    if c.get("num_local_experts"):
        ffn = c["num_experts_per_tok"] * 3 * d * f + d * c["num_local_experts"]
    else:
        ffn = 3 * d * f
    return c["num_hidden_layers"] * (attn + ffn) + d * c["vocab_size"]


def flops_per_sequence(c, seq):
    attn = 6 * seq * seq * c["num_attention_heads"] * c["head_dim"]
    return (6 * matmul_params_per_token(c) * seq
            + c["num_hidden_layers"] * attn)


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    flops = run.steps * run.batch * flops_per_sequence(run.cell.config,
                                                       run.seq)
    return 100.0 * flops / (run.window_s * PEAK_BF16)
