"""ops/ K10 (attention's backward): the summed bound of the backward of
every attention call under grad over the device time of its three
kernels."""

KERNELS = ("attn_bwd_rows_kernel", "attn_bwd_dq_tc_kernel",
           "attn_bwd_dkdv_tc_kernel")


def read(r):
    ms = sum(r["kernels_ms"].get(k, 0.0) for k in KERNELS)
    return r["bounds_ms"]["attention_bwd"] / ms * 100 if ms else None
