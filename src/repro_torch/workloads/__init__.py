from repro_torch.sim.workloads import zoo_names, zoo_workload
from repro_torch.workloads.synthetic import (ALL_BENCHMARKS, SUITES,
                                             make_workload)

__all__ = ["ALL_BENCHMARKS", "SUITES", "make_workload", "zoo_names",
           "zoo_workload"]
