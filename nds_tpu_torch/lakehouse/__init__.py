"""The lakehouse warehouse format of the port: snapshot-manifest tables
(table.py), zone maps (zonemap.py), reader leases (leases.py) and the fs
catalog (catalog.py), copies of nds_tpu/lakehouse/."""
