from cdk.kernels.cke import gather_peradv, onehot, problem, reference  # noqa: F401
from cdk.kernels.cke.problem import CkeData, init_data  # noqa: F401
from cdk.kernels.cke.reference import edge_flux  # noqa: F401
