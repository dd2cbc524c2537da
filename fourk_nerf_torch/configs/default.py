"""Default experiment schema.

Keeps key-for-key compatibility with the reference schema
(frozoul/4K-NeRF configs/default.py:1-121) so published per-scene configs
drop in unchanged. Values are the reference defaults.
"""
from copy import deepcopy

expname = None                    # experiment name
basedir = './logs/'               # where to store ckpts and logs

data = dict(
    datadir=None,                 # path to dataset root folder
    dataset_type=None,            # blender | llff | nsvf | blendedmvs | tankstemple | deepvoxels | co3d | nerfpp
    inverse_y=False,              # intrinsic mode (blendedmvs, nsvf, tankstemple)
    flip_x=False,                 # co3d
    flip_y=False,                 # co3d
    annot_path='',                # co3d
    split_path='',                # co3d
    sequence_name='',             # co3d
    load2gpu_on_the_fly=False,    # keep images on host, move per-batch
    testskip=1,                   # subsample testset to preview results
    white_bkgd=False,             # composite onto white background
    rand_bkgd=False,              # random background during training
    half_res=False,
    bd_factor=.75,
    movie_render_kwargs=dict(),

    # forward-facing llff specific
    ndc=False,
    spherify=False,
    factor=4,
    width=None,
    height=None,
    llffhold=20,
    load_depths=False,
    load_sr=0,                    # load hi-res SR ground truth at this factor (0 = off)

    # unbounded inward-facing specific
    unbounded_inward=False,
    unbounded_inner_r=1.0,
)

coarse_train = dict(
    N_iters=5000,                 # optimization steps
    N_rand=8192,                  # rays per optimization step
    lrate_density=1e-1,           # lr of density voxel grid
    lrate_k0=1e-1,                # lr of color/feature voxel grid
    lrate_rgbnet=1e-3,            # lr of the view-dependent color MLP
    lrate_decay=20,               # lr decays by 0.1 every lrate_decay*1000 steps
    pervoxel_lr=True,             # view-count-based per-voxel lr
    pervoxel_lr_downrate=1,       # image downsample rate for the view count
    ray_sampler='random',         # random | flatten | in_maskcache | patch_simg | patch_mimg | patch_box (TPU slab-sweep pretrain)
    weight_main=1.0,              # photometric loss
    weight_entropy_last=0.01,     # background entropy loss
    weight_nearclip=0,
    weight_distortion=0,
    weight_rgbper=0.1,            # per-point rgb loss
    tv_every=1,                   # TV loss every tv_every steps
    tv_after=0,                   # TV loss from this step on
    tv_before=0,                  # TV loss before this step
    tv_dense_before=0,            # dense (vs sparse) TV before this step
    weight_tv_density=0.0,
    weight_tv_k0=0.0,
    pg_scale=[],                  # steps at which the grid doubles (progressive scaling)
    decay_after_scale=1.0,        # act_shift decay applied after each scaling
    skip_zero_grad_fields=[],     # params whose zero-grad entries skip the Adam update
    maskout_lt_nviews=0,
)

fine_train = deepcopy(coarse_train)
fine_train.update(dict(
    N_iters=20000,
    pervoxel_lr=False,
    lrate_adanet=0,
    ray_sampler='in_maskcache',
    weight_entropy_last=0.001,
    weight_rgbper=0.01,
    pg_scale=[1000, 2000, 3000, 4000],
    skip_zero_grad_fields=['density', 'k0'],
))

coarse_model_and_render = dict(
    num_voxels=1024000,           # expected number of voxels
    num_voxels_base=1024000,      # to rescale delta distance
    density_type='DenseGrid',     # DenseGrid | TensoRFGrid
    k0_type='DenseGrid',
    density_config=dict(),
    k0_config=dict(),
    mpi_depth=128,                # number of MPI planes (ndc=True only)
    nearest=False,
    pre_act_density=False,
    in_act_density=False,
    bbox_thres=1e-3,              # known free-space threshold for fine-stage bbox
    mask_cache_thres=1e-3,        # threshold for the occupancy cache
    rgbnet_dim=0,                 # feature voxel grid channels (0 = plain rgb grid)
    rgbnet_full_implicit=False,
    rgbnet_direct=True,
    rgbnet_depth=3,
    rgbnet_width=128,
    alpha_init=1e-6,              # initial alpha everywhere
    fast_color_thres=1e-7,        # alpha/weight threshold that masks samples
    maskout_near_cam_vox=True,
    world_bound_scale=1,
    stepsize=0.5,                 # sampling step in voxel units
)

fine_model_and_render = deepcopy(coarse_model_and_render)
fine_model_and_render.update(dict(
    num_voxels=160**3,
    num_voxels_base=160**3,
    rgbnet_dim=12,
    alpha_init=1e-2,
    fast_color_thres=1e-4,
    maskout_near_cam_vox=False,
    world_bound_scale=1.05,
    mode_type='',
    dim_rend=3,
    act_type='relu',
))

del deepcopy
