"""Published peaks of the card the benchmark runs on (NVIDIA H100 SXM
data sheet, at its 700 W limit), against which a kernel's roofline share
is stated."""

HBM_BYTES_PER_S = 3.35e12  # device memory bandwidth
