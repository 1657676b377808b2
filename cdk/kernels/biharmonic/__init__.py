from cdk.kernels.biharmonic import dss, dss2d, operator, problem, reference  # noqa: F401
from cdk.kernels.biharmonic.problem import BiharmonicData, init_data  # noqa: F401
from cdk.kernels.biharmonic.reference import biharmonic_wk_reference  # noqa: F401
