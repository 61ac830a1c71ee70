"""The yardsticks of a kernel's roofline share, frozen here.

The peak: one NVIDIA H100 SXM (132 SMs) issues 64 INT32 multiply-adds a
clock on each SM (NVIDIA's H100 white paper: four sub-partitions of 16
INT32 lanes), at 1.98 GHz boost: 132 x 64 x 1.98e9 = 1.6727e13
multiply-adds/s, a 32x32->64-bit product counted as one.  The figure is
derived from the white paper, not a data-sheet number, and assumes the
card's full 700 W power limit; the benchmark prints the card's limit
beside it.

The work: an Ed25519 verification needs at least SIG_PRODUCTS 32x32->64
products on the fewest-product exact path in the port when the benchmark
was written, the table kernel K-T (csrc/tables.cu, verify_tables_kernel):
its 128 table additions of the double-base scalar multiplication plus the
point encode's inversion and checks, counted from its code as 117,670
products a signature (PERF.md, "Bounds, derived").  The generic kernel
K-G needs 284,470.  Every signature that reached the card is counted at
the lower figure, whatever kernel verified it, so the share reads the same
work whatever implements it and a faster algorithm cannot read above 100%.
"""

SMS, INT32_LANES_PER_SM, BOOST_HZ = 132, 64, 1.98e9
PEAK_MULADDS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ
SIG_PRODUCTS = 117_670

# the kernels that verify signatures (K-G, K-T, K-B), by the names their
# launches carry in a device trace
VERIFY_KERNELS = ("verify_generic_kernel", "verify_tables_kernel",
                  "build_tables_kernel")


def least_verify_s(signatures: int) -> float:
    """The least time the card could take to verify `signatures`."""
    return signatures * SIG_PRODUCTS / PEAK_MULADDS_PER_S
