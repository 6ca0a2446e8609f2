"""SPDC core of the port — the paper's contribution on PyTorch (mirrors
repro.core)."""
from .augment import augment_for_servers
from .cipher import cipher_flops
from .decipher import Determinant, decipher, decipher_batch, decipher_flops
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
from .prt import sign_preserved
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
    "augment_for_servers", "cipher_flops",
    "Determinant", "decipher", "decipher_batch", "decipher_flops",
    "FaultPlan", "ServerFault", "apply_faults", "corrupt_strip",
    "normalize_plan", "resolve_delays",
    "SPDCInverseResult", "outsource_inverse",
    "CommLog", "det_from_lu", "lu_block_row", "lu_blocked", "lu_diag_factor",
    "lu_nserver", "lu_panel_blocked", "lu_unblocked", "nserver_comm_model",
    "slogdet_from_lu", "slogdet_pair_from_lu",
    "SPDCBatchResult", "SPDCResult", "common_padded_size",
    "outsource_determinant", "outsource_determinant_mixed", "resolve_dtype",
    "sign_preserved",
    "Verdict", "authenticate", "epsilon", "growth_estimate", "localize",
    "per_server_residuals", "q1", "q2", "q3", "q3_paper_literal",
]
