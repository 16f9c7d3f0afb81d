"""Dataset factory (reference ``utils/utils.py:75-109 get_dataloader``;
counterpart of ``pixelpick_tpu/data/factory.py``)."""

from __future__ import annotations


def get_dataset(args, val: bool = False, query: bool = False,
                generate_init_queries: bool = True):
    name = args.dataset_name
    if name == "cs":
        from pixelpick_tpu_torch.data.cityscapes import CityscapesDataset
        return CityscapesDataset(args, val=val, query=query,
                                 generate_init_queries=generate_init_queries)
    if name == "cv":
        from pixelpick_tpu_torch.data.camvid import CamVidDataset
        return CamVidDataset(args, val=val, query=query,
                             generate_init_queries=generate_init_queries)
    if name == "voc":
        from pixelpick_tpu_torch.data.voc import VOC2012Segmentation
        return VOC2012Segmentation(args, val=val, query=query,
                                   generate_init_queries=generate_init_queries)
    from pixelpick_tpu_torch.data.custom import CustomDataset
    return CustomDataset(args, val=val, query=query,
                         generate_init_queries=generate_init_queries)
