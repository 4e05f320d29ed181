"""How the port builds, serves and checks each family of configurations.
A family module is found by the ``family`` of a configuration's file."""
