from cdk.dist import biharmonic, cke, mesh, mpdata  # noqa: F401
