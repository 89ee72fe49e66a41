"""Distribution: sharding policies over a ``DeviceMesh`` and the GPipe
schedule over one of its axes."""
