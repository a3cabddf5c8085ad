"""The decode attention kernel's share of its roofline over the traced
window's decode steps: the least time for the reads each call needs, over
the device time of ``decode_attention_kernel``.

Work a call (one layer, one token at position p): the valid cache rows
(p + 1, or the window) of K and V [kv_heads, head_dim], the cache's slot
positions (int32), q and the output [heads, head_dim]; 4 * head_dim *
heads flops a valid row.  It computes in f32 outside the tensor cores."""
from portbench import bench


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    d = run.dims
    if tr is None:
        return None
    secs, n = tr.kernel_seconds("decode_attention_kernel")
    if n == 0 or secs <= 0:
        return None
    elem = 2 if ctx["dtype"] in ("bfloat16", "float16") else 4
    peak = bench.matmul_peak(ctx["dtype"], ctx["tf32"])
    bound = 0.0
    for name, _, _ in tr.spans:
        if name.startswith("serve.decode:pos="):
            p = int(name.split("=")[1])
            rows = p + 1 if d.window <= 0 else min(p + 1, d.window)
            nbytes = (elem * 2 * rows * d.n_kv_heads * d.head_dim
                      + 4 * run.cache_len
                      + elem * 2 * d.n_heads * d.head_dim)
            flops = 4 * d.head_dim * d.n_heads * rows
            bound += d.n_layers * max(nbytes / bench.HBM_BYTES_PER_S,
                                      flops / peak)
    return 100.0 * bound / secs
