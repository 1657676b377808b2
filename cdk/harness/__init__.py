from cdk.harness import driver, specs  # noqa: F401
