"""The per-example-norm kernels' share of their roofline: Σ over the tap
sites of a norms pass of the least time of the site's per-example-norm
work, times the profiled norms passes, over the device time of the norm
kernels (gram, direct and segmented, by the names ``csrc/`` gives them,
with the reduction of partial sums each of them launches) in the
profile.

Work is counted from shapes alone, so it reads the same whatever form or
kernel the program picks. A dense site with inputs H (S × p_in) and output
gradients Z̄ (S × p_out) per example: the fewer operations of the gram
form, S(S+1)(p_in + p_out) + 2S² (each Gram matrix's distinct pairs,
then their product), and the direct form, 2·S·p_in·p_out + 2·p_in·p_out
(Hᵀ Z̄, then its squares); B times. Bytes: H, Z̄ and the (B,) float32
output once each, an H that several sites read (q, k and v; gate and up)
once in all. Expert sites: each (example, expert) segment at the even
share n = S·k/E of an example's slots, the least any routing needs for
the gram form (the direct form's work does not depend on it). Least time
of a site: max(operations ÷ peak, bytes ÷ 3.35 TB/s), peak 989 TFLOP/s
for bf16 and 67 for the float32 router. Sites whose stats are not those
kernels' (embedding, biases, norm gains) are not counted."""
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Kernels"
MOVES = "tokens_per_s"

PEAK = {"bfloat16": 989e12, "float32": 67e12}
HBM = 3.35e12
KERNELS = (r"\b(gram_partial|gram_partial_wgmma|gram_fold|direct_partial|"
           r"direct_partial_wgmma|segmented_partial|segmented_partial_mma|"
           r"segmented_gram|segmented_gram_wgmma|segment_sums|reduce_partials)\b")


def site_ops(s, p_in, p_out):
    gram = s * (s + 1) * (p_in + p_out) + 2 * s * s
    direct = 2 * s * p_in * p_out + 2 * p_in * p_out
    return min(gram, direct)


def least_seconds(c, batch, seq):
    """Least time of one norms pass's per-example-norm work."""
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hq = c["num_attention_heads"] * c["head_dim"]
    hkv = c["num_key_value_heads"] * c["head_dim"]
    dt = c["run"]["dtype"]
    size = {"bfloat16": 2, "float32": 4}[dt]
    rows = batch * seq
    # (ops, bytes, precision) of each site; H bytes on the first reader
    sites = [(batch * site_ops(seq, d, hq), rows * (d + hq) * size, dt),
             (batch * site_ops(seq, d, hkv), rows * hkv * size, dt),
             (batch * site_ops(seq, d, hkv), rows * hkv * size, dt),
             (batch * site_ops(seq, hq, d), rows * (hq + d) * size, dt)]
    if c.get("num_local_experts"):
        e, k = c["num_local_experts"], c["num_experts_per_tok"]
        n = seq * k / e
        slots = rows * k
        seg = batch * e

        def expert(p_in, p_out):
            return seg * (min(n * (n + 1) * (p_in + p_out) + 2 * n * n,
                              2 * n * p_in * p_out + 2 * p_in * p_out))
        sites += [(batch * site_ops(seq, d, e), rows * (d + e) * 4,
                   "float32"),
                  (expert(d, f), slots * (d + f) * size, dt),
                  (expert(d, f), slots * f * size, dt),
                  (expert(f, d), slots * (f + d) * size, dt)]
    else:
        sites += [(batch * site_ops(seq, d, f), rows * (d + f) * size, dt),
                  (batch * site_ops(seq, d, f), rows * f * size, dt),
                  (batch * site_ops(seq, f, d), rows * (f + d) * size, dt)]
    per_layer = sum(max(ops / PEAK[p], (b + batch * 4) / HBM)
                    for ops, b, p in sites)
    head = max(batch * site_ops(seq, d, v) / PEAK[dt],
               (rows * (d + v) * size + batch * 4) / HBM)
    return c["num_hidden_layers"] * per_layer + head


def read(run):
    p = run.profile
    if p is None:
        return None
    spent = p.seconds(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * p.n_steps * least_seconds(run.cell.config, run.batch,
                                             run.seq) / spent
