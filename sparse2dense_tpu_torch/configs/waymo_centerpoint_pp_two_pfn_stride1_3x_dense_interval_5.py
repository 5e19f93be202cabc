# CenterPoint-Pillar on Waymo, the dense teacher: the first stage of the
# pillar Sparse2Dense recipe, whose last checkpoint the second stage
# (waymo_centerpoint_pp_two_pfn_stride1_3x_distill_interval_5.py) loads as
# its teacher through load_from. Copied from the reference zoo entry
# (sparse2dense_tpu/zoo.py: _pp_model, _centerhead, the assigner, train_cfg,
# test_cfg, voxel_generator, the data block's batch and _runtime of waymo_pp
# "dense_interval_5"): a plain PointPillars (S_model, distillation off) with
# the two-layer pillar feature net, the pillar scatter on a 468x468 grid of
# 0.32 m, the three-level RPN and a CenterHead, trained for 6 epochs at
# samples_per_gpu=8. The reference trains it on the dense point clouds (its
# data pipeline's distillation streams); the synthetic frames of
# tools/train.py stand in.
import itertools

tasks = [dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"])]
class_names = list(itertools.chain(*[t["class_names"] for t in tasks]))
target_assigner = dict(tasks=tasks)

S_model = dict(
    type="PointPillars",
    pretrained=None,
    reader=dict(type="PillarFeatureNet", num_filters=[64, 64], num_input_features=5,
                with_distance=False, voxel_size=(0.32, 0.32, 6.0),
                pc_range=(-74.88, -74.88, -2, 74.88, 74.88, 4.0)),
    backbone=dict(type="PointPillarsScatter", ds_factor=1),
    neck=dict(type="RPN", layer_nums=[3, 5, 5], ds_layer_strides=[1, 2, 2],
              ds_num_filters=[64, 128, 256], us_layer_strides=[1, 2, 4],
              us_num_filters=[128, 128, 128], num_input_features=64),
    bbox_head=dict(type="CenterHead", in_channels=384, tasks=tasks, dataset="waymo", weight=2,
                   code_weights=[1.0] * 8,
                   common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                                 "rot": (2, 2)}),
)

assigner = dict(target_assigner=target_assigner, out_size_factor=1, dense_reg=1,
                gaussian_overlap=0.1, max_objs=500, min_radius=2)
train_cfg = dict(assigner=assigner)

test_cfg = dict(
    post_center_limit_range=[-80, -80, -10.0, 80, 80, 10.0],
    nms=dict(nms_pre_max_size=4096, nms_post_max_size=500, nms_iou_threshold=0.7),
    score_threshold=0.1, pc_range=[-74.88, -74.88], out_size_factor=1,
    voxel_size=[0.32, 0.32],
)

# max_voxel_num: (train, test)
voxel_generator = dict(range=[-74.88, -74.88, -2, 74.88, 74.88, 4.0],
                       voxel_size=[0.32, 0.32, 6.0], max_points_in_voxel=20,
                       max_voxel_num=[32000, 60000], distillation=True)

optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True, moving_average=False)
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85], div_factor=10.0,
                 pct_start=0.4)
# the reference's data block; its dataset entries wait for the data layer
data = dict(samples_per_gpu=8, workers_per_gpu=6)
checkpoint_config = dict(interval=1)
log_config = dict(interval=5, hooks=[dict(type="TextLoggerHook")])
total_epochs = 6
log_level = "INFO"
work_dir = None
load_from = None
resume_from = None
workflow = [("train", 1)]
distillation = False
