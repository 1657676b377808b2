from cdk.kernels.mpdata import hopper, problem, reference  # noqa: F401
from cdk.kernels.mpdata.problem import MpdataData, init_data  # noqa: F401
from cdk.kernels.mpdata.reference import advect_scalar2d  # noqa: F401
