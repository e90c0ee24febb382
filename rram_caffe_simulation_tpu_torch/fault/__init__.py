"""RRAM fault engine, fault processes, packed banks, crossbar read
(kernel B2) and the fused ApplyUpdate+Fail epilogue (kernel B1)."""
from .processes import (FaultProcess, FaultSpec, ProcessStack,
                        register_fault_process)

__all__ = ["FaultProcess", "FaultSpec", "ProcessStack",
           "register_fault_process"]
