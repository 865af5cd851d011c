"""The block warp kernel (K1) in the profiled stretch: the least time its
bytes need at the card's bandwidth, from the shapes of its launches, as a
share of the device time of its kernels (prep and warp)."""

from benchmark.harness import HBM_BYTES_PER_S

NAMES = ("block_warp_kernel", "block_prep")


def read(rec):
    prof = rec.get("profile")
    if not prof or not rec.get("k1_bytes"):
        return None
    k1_s = sum(s for n, s in prof["device_s_by_name"].items()
               if any(k in n for k in NAMES))
    if k1_s <= 0:
        return None
    return 100.0 * sum(rec["k1_bytes"]) / HBM_BYTES_PER_S / k1_s
