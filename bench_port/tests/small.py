"""Small sizes for the CPU tests: the cells' flags, scenes and traffic cut
so that a run takes seconds on the CPU. Only the tests use them."""

SCENE = {"height": 64, "width": 96, "focal": 100.0, "side_valid_rows": 44,
         "detail_hw": [4, 6], "label_cell_px": 8}
FLAGS = {
    "zip_hash": {"zip_batch_size": "256", "zip_num_prop_samples": "(8, 8)",
                 "zip_num_nerf_samples": "8", "zip_grid_num_levels": "4",
                 "zip_log2_hashmap_size": "12",
                 "zip_prop_grid_resolutions": "(64, 128)",
                 "zip_nerf_grid_resolution": "256", "chunk": "512"},
    "cp_hash": {"zip_batch_size": "256", "zip_num_prop_samples": "(8, 8)",
                "zip_num_nerf_samples": "8", "zip_cp_level_dim": "8",
                "zip_cp_base_resolution": "16", "zip_cp_max_resolution": "64",
                "zip_cp_hash_log2": "12", "zip_ipe_density_width": "128",
                "zip_density_hidden_width": "128", "zip_ipe_max_deg": "4",
                "chunk": "512"},
}
TRAFFIC = {"train": {}, "render": {"frames": 2, "strip_rows": 16,
                                   "sample_strips": 3, "sample_chunks": 4}}


def overrides(config: str, traffic: str):
  return {"flags": FLAGS[config], "scene": SCENE,
          "traffic": TRAFFIC[traffic]}
