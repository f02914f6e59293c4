"""Data substrate of the port: device-resident columnar relations and the
synthetic dataset generators."""
