from .batch import (  # noqa: F401
    BatchProver,
    DeviceParams,
    batched_prove_signature_list,
    device_params_for,
    resolve_device,
)
from .batch_verify import BatchVerifier, batch_verify_signature_list  # noqa: F401
from .verify import batched_verify_signature_list, device_msm, device_msm_backend  # noqa: F401
