"""The flash backward's share of its roofline over the traced window: the
least time its calls could take, over the device time of its three kernels
(``bwd_stats_kernel``, ``bwd_dkdv_kernel``, ``bwd_dq_kernel``).

One call a layer a step.  Work a call: five products over the causal pairs
(S = Q K^T again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q), 2 *
head_dim flops a pair a head each; bytes: q, o, dO and dq [B, T, heads,
head_dim], k, v, dk and dv [B, T, kv_heads, head_dim] once.  Its products
run on the bf16 tensor cores whatever the input dtype."""
from portbench import bench


def read(ctx):
    tr, d = ctx["trace"], ctx["dims"]
    if tr is None or not ctx["steps"]:
        return None
    secs, n = tr.kernel_seconds("bwd_stats_kernel", "bwd_dkdv_kernel",
                                "bwd_dq_kernel")
    if n == 0 or secs <= 0:
        return None
    b, t = ctx["batch"], ctx["seq_len"]
    elem = 2 if ctx["dtype"] in ("bfloat16", "float16") else 4
    flops = 5 * 2 * d.head_dim * d.n_heads * b * t * (t + 1) // 2
    nbytes = elem * b * t * d.head_dim * 4 * (d.n_heads + d.n_kv_heads)
    call = max(flops / bench.kernel_peak(ctx["dtype"]),
               nbytes / bench.HBM_BYTES_PER_S)
    return 100.0 * call * d.n_layers * ctx["steps"] / secs
