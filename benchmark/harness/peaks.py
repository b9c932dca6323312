"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit).  A card set below that limit runs
slower under load: every result names the card, and PERF.md its limit."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "l2_bytes": 50 * 2 ** 20,
    "flops": {"float64": 67e12, "float64_vector": 34e12, "float32": 67e12,
              "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12},
}
