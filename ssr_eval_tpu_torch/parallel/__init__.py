from ssr_eval_tpu_torch.parallel.mesh import DataMesh, data_mesh, device_mesh, pad_batch_for_mesh

__all__ = ["DataMesh", "data_mesh", "device_mesh", "pad_batch_for_mesh"]
