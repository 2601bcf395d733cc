from hidegs_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
