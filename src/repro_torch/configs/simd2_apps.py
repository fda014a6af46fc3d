"""The paper's own workloads (Table 4): 8 applications x 3 input sizes.

Counterpart of ``repro/configs/simd2_apps.py``, the same numbers.
"""

APP_SIZES = {
    "apsp":  {"small": 4096, "medium": 8192, "large": 16384},
    "aplp":  {"small": 4096, "medium": 8192, "large": 16384},
    "mcp":   {"small": 4096, "medium": 8192, "large": 16384},
    "maxrp": {"small": 4096, "medium": 8192, "large": 16384},
    "minrp": {"small": 4096, "medium": 8192, "large": 16384},
    "mst":   {"small": 1024, "medium": 2048, "large": 4096},
    "gtc":   {"small": 1024, "medium": 4096, "large": 8192},
    "knn":   {"small": 4096, "medium": 8192, "large": 16384},
}

# CPU-host benchmark sizes (same ratios, scaled so the suite finishes):
BENCH_SIZES = {
    "apsp":  {"small": 256, "medium": 512, "large": 1024},
    "aplp":  {"small": 256, "medium": 512, "large": 1024},
    "mcp":   {"small": 256, "medium": 512, "large": 1024},
    "maxrp": {"small": 256, "medium": 512, "large": 1024},
    "minrp": {"small": 256, "medium": 512, "large": 1024},
    "mst":   {"small": 128, "medium": 256, "large": 512},
    "gtc":   {"small": 128, "medium": 512, "large": 1024},
    "knn":   {"small": 256, "medium": 512, "large": 1024},
}
