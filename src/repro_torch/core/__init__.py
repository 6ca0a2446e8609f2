"""SPDC core of the port — the paper's contribution on PyTorch (mirrors
repro.core)."""
from .decipher import Determinant, decipher, decipher_batch
from .faults import (
    FaultPlan,
    ServerFault,
    apply_faults,
    corrupt_strip,
    normalize_plan,
    resolve_delays,
)
from .inverse import SPDCInverseResult, outsource_inverse
from .lu import (
    CommLog,
    det_from_lu,
    lu_block_row,
    lu_blocked,
    lu_diag_factor,
    lu_nserver,
    lu_panel_blocked,
    lu_unblocked,
    nserver_comm_model,
    slogdet_from_lu,
    slogdet_pair_from_lu,
)
from .protocol import (
    SPDCBatchResult,
    SPDCResult,
    common_padded_size,
    outsource_determinant,
    outsource_determinant_mixed,
    resolve_dtype,
)
from .verify import (
    Verdict,
    authenticate,
    epsilon,
    growth_estimate,
    localize,
    per_server_residuals,
    q1,
    q2,
    q3,
    q3_paper_literal,
)

__all__ = [
    "Determinant", "decipher", "decipher_batch",
    "FaultPlan", "ServerFault", "apply_faults", "corrupt_strip",
    "normalize_plan", "resolve_delays",
    "SPDCInverseResult", "outsource_inverse",
    "CommLog", "det_from_lu", "lu_block_row", "lu_blocked", "lu_diag_factor",
    "lu_nserver", "lu_panel_blocked", "lu_unblocked", "nserver_comm_model",
    "slogdet_from_lu", "slogdet_pair_from_lu",
    "SPDCBatchResult", "SPDCResult", "common_padded_size",
    "outsource_determinant", "outsource_determinant_mixed", "resolve_dtype",
    "Verdict", "authenticate", "epsilon", "growth_estimate", "localize",
    "per_server_residuals", "q1", "q2", "q3", "q3_paper_literal",
]
