"""The FLOP and byte counts against counts worked out by hand at small
shapes."""

from benchmark import flops

VOC = dict(num_mels=2, upsample_initial_channel=8, upsample_rates=[2],
           upsample_kernel_sizes=[4], resblock="1", resblock_kernel_sizes=[3],
           resblock_dilation_sizes=[[1]])


def test_denoiser_counts():
    # 2T(MC + 8LC^2 + C^2 + CM) at T=2, C=4, L=1, M=3: 4 (12 + 128 + 16 + 12)
    assert flops.eval_flops(2, 4, 1, 3) == 672
    # 2T L H 2C at T=2, C=4, L=1, H=5: 2*2*1*5*8
    assert flops.cond_flops(2, 4, 1, 5) == 160
    # per layer and row 4 products of 2 C 2C, B=2 T=3 C=4 L=1: 2*4*2*3*4*8
    assert flops.stack_forward_flops(2, 3, 4, 1) == 1536
    assert flops.train_model_flops(2, 3, 4, 1) == 3 * 1536
    # 50 PLMS steps at acc 20 and the first step's second evaluation
    assert flops.sampler_evals(1000, 20) == 51


def test_vocoder_counts():
    # T=5 mel frames, C0=8, one stage of rate 2 to 4 channels, k=4:
    # conv_pre 2*5*2*8*7, ConvT 2*5*8*4*4, the stage at T=10: noise conv
    # (last stage, k=1) 2*10*4, resblock 1 (k=3, one dilation, convs1 and
    # convs2) 2 * 2*10*4*4*3, conv_post 2*10*4*7
    parts = flops.vocoder_parts(VOC, 5)
    assert parts == {"pre": 1120, "up0": 1280, "noise0": 80, "res0": 1920,
                     "post": 560}
    # 4 channels <= 128: K3 owns stage 0's resblocks and conv_post
    assert flops.tail_start(VOC) == 0
    assert flops.tail_flops(VOC, 5) == 1920 + 560


def test_hubert_counts():
    cfg = dict(dim=32, num_heads=2, num_layers=1, ffn_dim=64, proj_dim=8)
    # 400 samples + 80 of padding: conv frames 95, 47, 23, 11, 5, 2, 1
    convs = (2 * 512 * 10 * 95 + 2 * 512 * 512 * 3 * (47 + 23 + 11 + 5)
             + 2 * 512 * 512 * 2 * (2 + 1))
    # T=1: projection 2*512*32, positional conv 2*32*2*128, one layer
    # (qkv 2*32*96, scores and mix 2 * 2*1*32, out 2*32*32, ffn 2 * 2*32*64),
    # the unit head 2*32*8
    rest = (2 * 512 * 32 + 2 * 32 * 2 * 128
            + (2 * 32 * 96 + 2 * 2 * 32 + 2 * 32 * 32 + 2 * 2 * 32 * 64)
            + 2 * 32 * 8)
    assert flops.hubert_flops(400, cfg) == convs + rest


def test_bounds_and_bytes():
    # compute-bound: 989e12 FLOPs at bf16 take 1 s
    assert flops.bound_s(989e12, 1.0, "bf16") == 1.0
    # byte-bound: 3.35e12 bytes take 1 s whatever the precision
    assert flops.bound_s(1.0, 3.35e12, "f32") == 1.0
    # K2 at T=2, C=4, L=1, M=3, J=5 evaluations, bf16: x in and out f32
    # 2*2*3*4; step biases 1*5*4, conditioner 1*2*8, weights
    # (12 + 4 + 16 + 4 + 12 + 3) + (96 + 8 + 32 + 8), each 2 bytes
    assert flops.ladder_bytes(2, 4, 1, 3, 5, "bf16") == (
        48 + 2 * (20 + 16 + 51 + 144))
