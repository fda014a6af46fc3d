"""The paper's benchmark applications on the SIMD² path, their graph
generators and the independent classic-algorithm baselines."""
from repro_torch.apps import baselines, graphs
from repro_torch.apps.solvers import (ALL_APPS, aplp, apsp, gtc, knn, maxcp,
                                      maxrp, minrp, mst_edges, mst_minimax)

__all__ = ["ALL_APPS", "apsp", "aplp", "maxcp", "maxrp", "minrp",
           "mst_minimax", "mst_edges", "gtc", "knn", "baselines", "graphs"]
