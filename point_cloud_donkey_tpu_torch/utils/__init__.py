"""Host-side utilities of the port (counterparts of point_cloud_donkey_tpu.utils)."""
