"""The whole decode step's share of the card's peak over the traced
window: the least time a decode step could take, over the device time of
every kernel the decode steps launched.

A step at position p reads every weight once (the layers' products and the
head over the published vocabulary) and the valid cache rows of every layer, and writes one
row of K and V a layer; it does 2 flops a weight and 4 * head_dim * heads
flops a valid row a layer.  Bound: the larger of the bytes over the HBM
rate and the flops over the peak of a cuBLAS product of the run's dtype."""
from portbench import bench


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    d = run.dims
    if tr is None:
        return None
    elem = 2 if ctx["dtype"] in ("bfloat16", "float16") else 4
    layer = (d.d_model * d.head_dim * (2 * d.n_heads + 2 * d.n_kv_heads)
             + 3 * d.d_model * d.d_ff)
    weights = d.n_layers * layer + d.vocab_size * d.d_model
    peak = bench.matmul_peak(ctx["dtype"], ctx["tf32"])
    bound = secs = 0.0
    for name, ks in tr.kernels_in("serve.decode:pos="):
        p = int(name.split("=")[1])
        rows = p + 1 if d.window <= 0 else min(p + 1, d.window)
        kv = 2 * d.n_kv_heads * d.head_dim * d.n_layers
        nbytes = elem * (weights + kv * (rows + 1))
        flops = 2 * weights + d.n_layers * 4 * d.head_dim * d.n_heads * rows
        bound += max(nbytes / bench.HBM_BYTES_PER_S, flops / peak)
        secs += sum(e - s for _, s, e in ks) / 1e9
    if secs <= 0:
        return None
    return 100.0 * bound / secs
