from .batch import DeviceParams, device_params_for, resolve_device  # noqa: F401
from .batch_verify import BatchVerifier, batch_verify_signature_list  # noqa: F401
