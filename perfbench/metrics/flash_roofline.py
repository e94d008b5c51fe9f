"""The flash attention kernels' share of their roofline: the least time
of causal attention's forward and backward at the cell's shapes, times
the profiled steps, over the device time of the three flash kernels
(forward, dQ, dK/dV, by the names ``csrc/flash_attention.cu`` gives them)
in the profile.

Per layer and step: forward 2·B·H·S²·D operations (QKᵀ and PV over the
causal half of the S² pairs), backward 4·B·H·S²·D (dV, dP, dQ, dK); the
recompute that remat adds is not counted. Bytes: the forward reads Q, K,
V and writes O and the float32 log-sum-exp; the backward reads Q, K, V,
O, dO and the log-sum-exp and writes dQ, dK and dV, each once (K and V at
the published key/value heads). Least time of each: max(operations ÷ 989
TFLOP/s, bytes ÷ 3.35 TB/s)."""
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Kernels"
MOVES = "tokens_per_s"

PEAK = 989e12
HBM = 3.35e12
KERNELS = r"\b(fwd_mma|dq_mma|dkv_mma|fwd_f32|dq_f32|dkv_f32)\b"


def least_seconds(c, batch, seq):
    h, hkv, d = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    size = {"bfloat16": 2, "float32": 4}[c["run"]["dtype"]]
    q = batch * seq * h * d * size
    kv = batch * seq * hkv * d * size
    lse = batch * h * seq * 4
    core = batch * h * seq * seq * d
    fwd = max(2 * core / PEAK, (q + 2 * kv + q + lse) / HBM)
    bwd = max(4 * core / PEAK, (3 * q + 2 * kv + lse + q + 2 * kv) / HBM)
    return c["num_hidden_layers"] * (fwd + bwd)


def read(run):
    p = run.profile
    if p is None or not run.cell.config["run"].get("flash"):
        return None
    spent = p.seconds(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * p.n_steps * least_seconds(run.cell.config, run.batch,
                                             run.seq) / spent
