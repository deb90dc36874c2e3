"""Point-cloud ops of the port (counterparts of point_cloud_donkey_tpu.ops)."""
