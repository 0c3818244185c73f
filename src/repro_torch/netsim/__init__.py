"""repro.netsim — flow-level fluid network simulator (flowsim analogue)."""
from .topology import Topology, SingleToR, FatTree, GB, Gb
from .fluid import FluidNet, LOCAL_BW
from .events import EventQueue

__all__ = ["Topology", "SingleToR", "FatTree", "GB", "Gb",
           "FluidNet", "LOCAL_BW", "EventQueue"]
