"""Port of `repro.launch`: the serving launcher (`serve`), the train step
(`steps`) and the training launcher (`train`), co-design rates
(`roofline`), the compile service and the fleet."""
