"""Kernel implementations: biharmonic, mpdata, cke.

Importing this package registers all variants in cdk.core.registry."""

from cdk.kernels import biharmonic, cke, mpdata  # noqa: F401
