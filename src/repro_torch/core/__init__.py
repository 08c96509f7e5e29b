"""Channel, protocol, wire and aggregation primitives of the paper's method
(§III), ported from ``repro.core``."""

from repro_torch.core.aggregation import (
    aggregate,
    aggregate_sparse,
    aggregate_wire,
    max_intermediate_elems,
)
from repro_torch.core.channel import ChannelConfig, ChannelSimulator, ChannelState, topk_budget_batch
from repro_torch.core.distill import soft_labels
from repro_torch.core.faults import (
    FAULTS,
    FaultCarry,
    FaultConfig,
    FaultResolution,
    FaultSimulator,
    corrupt_wire,
    get_faults,
    quarantine_wire,
    validate_dense,
    validate_wire,
)
from repro_torch.core.protocol import CommLedger, PayloadSpec, UplinkPayload, downlink_bits
from repro_torch.core.scenario import SCENARIOS, ScenarioConfig, get_scenario
from repro_torch.core.topk import (
    QUANT_LEVELS,
    QuantizedWire,
    SparseWire,
    concat_wires,
    densify,
    pad_wire,
    quantize_wire,
    sparsify_wire,
    take_wire_rows,
    topk_mask_batch,
    topk_mask_dense,
    topk_mask_dynamic,
    topk_sparsify,
)

__all__ = [
    "aggregate",
    "aggregate_sparse",
    "aggregate_wire",
    "max_intermediate_elems",
    "ChannelConfig",
    "ChannelSimulator",
    "ChannelState",
    "topk_budget_batch",
    "FAULTS",
    "FaultCarry",
    "FaultConfig",
    "FaultResolution",
    "FaultSimulator",
    "corrupt_wire",
    "get_faults",
    "quarantine_wire",
    "validate_dense",
    "validate_wire",
    "SCENARIOS",
    "ScenarioConfig",
    "get_scenario",
    "CommLedger",
    "PayloadSpec",
    "UplinkPayload",
    "downlink_bits",
    "soft_labels",
    "QUANT_LEVELS",
    "QuantizedWire",
    "SparseWire",
    "quantize_wire",
    "sparsify_wire",
    "pad_wire",
    "concat_wires",
    "take_wire_rows",
    "densify",
    "topk_sparsify",
    "topk_mask_batch",
    "topk_mask_dense",
    "topk_mask_dynamic",
]
